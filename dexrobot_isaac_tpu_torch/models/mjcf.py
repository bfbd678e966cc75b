"""MJCF (MuJoCo XML) loader: a hand model file -> HandModel (numpy).

The port's copy of `dexrobot_isaac_tpu/models/mjcf.py` (the port imports
nothing of the JAX package); a test holds the two loaders' arrays equal on
the vendored `dexrobot_isaac_tpu/assets/dexhand021_right_simplified_floating.xml`
and `tests/fixtures/dexhand021_upstream_format.xml`. `factory.make_env`
loads `env.handAsset` through it. The reference loads the same file through
Isaac Gym's asset pipeline (hand_initializer.py:209-257).

Supported subset:
- a nested <body> tree with pos/quat/euler and childclass propagation; a
  body with several joints becomes a chain of one-joint bodies, and a body
  without a joint (a fixed body) is folded into its children's frames:
  their orientation composes with its quaternion, but their offsets are
  added to its position without its rotation, as the JAX loader does
  (ROADMAP §3);
- <joint> hinge/slide with axis, range, damping, armature, limited;
- <geom> sphere, capsule (three spheres along its axis) and box (one sphere
  of the smallest half-size) as collision spheres; visual-only geoms
  (type="mesh", or contype=0 with conaffinity=0) generate no collision, and
  the primitive ones among them (sphere, capsule by `fromto` or `size`, box)
  go into `HandModel.visual_geoms` for the renderer (meshes are skipped);
- <site> frames; <inertial> mass/pos/diaginertia(+quat)/fullinertia, else
  geom-derived point masses;
- <default> class hierarchies through `class` and `childclass`;
- <compiler angle="degree|radian" autolimits>;
- <position> actuators: kp -> joint stiffness.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from dexrobot_isaac_tpu_torch.models.dexhand021 import PRISMATIC, REVOLUTE, HandModel


def _parse_vec(text: Optional[str], default=None) -> Optional[np.ndarray]:
    if text is None:
        return None if default is None else np.asarray(default, dtype=np.float64)
    return np.asarray([float(x) for x in text.split()], dtype=np.float64)


def _euler_to_quat(euler: np.ndarray) -> np.ndarray:
    """MJCF default eulerseq xyz (extrinsic) -> xyzw quaternion."""
    cx, sx = np.cos(euler[0] / 2), np.sin(euler[0] / 2)
    cy, sy = np.cos(euler[1] / 2), np.sin(euler[1] / 2)
    cz, sz = np.cos(euler[2] / 2), np.sin(euler[2] / 2)
    # R = Rz * Ry * Rx for extrinsic xyz
    return np.array([
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
        cx * cy * cz + sx * sy * sz,
    ])


class _Defaults:
    """MJCF default-class hierarchy: nested <default class="X"> blocks
    inherit attribute dicts from their enclosing block; elements resolve
    through their `class` attribute (or the enclosing body's `childclass`),
    falling back to the anonymous top-level default."""

    _KINDS = ("joint", "geom", "site")

    def __init__(self, root: ET.Element):
        empty = {k: {} for k in self._KINDS}
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {"": empty}

        def collect(delem: ET.Element, inherited):
            merged = {
                k: dict(inherited[k]) for k in self._KINDS
            }
            for k in self._KINDS:
                e = delem.find(k)
                if e is not None:
                    merged[k].update(e.attrib)
            name = delem.get("class", "")
            self.classes[name] = merged
            for child in delem.findall("default"):
                collect(child, merged)

        d = root.find("default")
        if d is not None:
            collect(d, empty)

    def _get(self, kind: str, elem: ET.Element, key: str, default: str,
             active_class: str) -> str:
        cls = elem.get("class", active_class)
        attrs = self.classes.get(cls, self.classes[""])[kind]
        return elem.get(key, attrs.get(key, default))

    def joint_get(self, elem, key, default, active_class=""):
        return self._get("joint", elem, key, default, active_class)

    def geom_get(self, elem, key, default, active_class=""):
        return self._get("geom", elem, key, default, active_class)


def load_mjcf(path: str) -> HandModel:
    """Parse an MJCF file into a HandModel (one 1-DOF joint per body)."""
    tree = ET.parse(path)
    root = tree.getroot()
    defaults = _Defaults(root)
    comp = root.find("compiler")
    degree = comp is not None and comp.get("angle", "degree") == "degree"
    autolimits = comp is not None and comp.get(
        "autolimits", "false"
    ) == "true"

    def _ang(x: float) -> float:
        return float(np.deg2rad(x)) if degree else float(x)

    def _orient(elem: ET.Element) -> np.ndarray:
        """pos/quat/euler orientation honoring compiler angle units."""
        q = _parse_vec(elem.get("quat"))
        if q is not None:
            return np.array([q[1], q[2], q[3], q[0]])
        e = _parse_vec(elem.get("euler"))
        if e is not None:
            return _euler_to_quat(np.deg2rad(e) if degree else e)
        return np.array([0.0, 0.0, 0.0, 1.0])

    # actuator kp per joint name
    kp_map: Dict[str, float] = {}
    act = root.find("actuator")
    if act is not None:
        for pos in act.findall("position"):
            kp_map[pos.get("joint", "")] = float(pos.get("kp", "0"))

    body_names: List[str] = []
    parent: List[int] = []
    joint_type: List[int] = []
    axis: List[np.ndarray] = []
    attach_pos: List[np.ndarray] = []
    attach_quat: List[np.ndarray] = []
    post_quat: List[np.ndarray] = []
    mass: List[float] = []
    com: List[np.ndarray] = []
    inertia: List[np.ndarray] = []
    lower: List[float] = []
    upper: List[float] = []
    stiffness: List[float] = []
    damping: List[float] = []
    armature: List[float] = []
    sites: List[Tuple[str, int, np.ndarray, np.ndarray]] = []
    spheres: List[Tuple[int, np.ndarray, float]] = []
    vgeoms: List[tuple] = []

    def walk(elem: ET.Element, parent_idx: int, pending_pos, pending_quat,
             active_class: str = ""):
        """Recurse the body tree. Bodies with multiple joints expand into a
        chain of single-joint bodies (the engine's reduced-coordinate form).
        `active_class` is the nearest enclosing body childclass."""
        for body in elem.findall("body"):
            b_pos = _parse_vec(body.get("pos"), [0, 0, 0])
            b_quat = _orient(body)
            joints = body.findall("joint")
            name = body.get("name", f"body{len(body_names)}")
            b_class = body.get("childclass", active_class)

            cur_parent = parent_idx
            cur_pos = pending_pos + b_pos if cur_parent == parent_idx else b_pos
            cur_quat = _quat_mul_np(pending_quat, b_quat)

            if not joints:
                # fixed body: fold its frame into children via pending offset
                walk(body, cur_parent, cur_pos, cur_quat, b_class)
                continue

            for j_i, joint in enumerate(joints):
                idx = len(body_names)
                is_last = j_i == len(joints) - 1
                body_names.append(name if is_last else f"{name}_j{j_i}")
                parent.append(cur_parent)
                jg = lambda k, d: defaults.joint_get(joint, k, d, b_class)
                jt = jg("type", "hinge")
                is_hinge = jt != "slide"
                joint_type.append(PRISMATIC if jt == "slide" else REVOLUTE)
                ax = _parse_vec(joint.get("axis"), [0, 0, 1])
                axis.append(ax / np.linalg.norm(ax))
                attach_pos.append(cur_pos if j_i == 0 else np.zeros(3))
                attach_quat.append(
                    cur_quat if j_i == 0 else np.array([0, 0, 0, 1.0])
                )
                post_quat.append(np.array([0, 0, 0, 1.0]))
                rng = _parse_vec(joint.get("range"), [0, 0])
                has_range = joint.get("range") is not None or jg(
                    "range", ""
                ) != ""
                if joint.get("range") is None and jg("range", "") != "":
                    rng = _parse_vec(jg("range", "0 0"))
                limited = jg("limited", "false") == "true" or (
                    autolimits and has_range
                )
                conv = _ang if is_hinge else float
                lower.append(conv(rng[0]) if limited else -np.pi)
                upper.append(conv(rng[1]) if limited else np.pi)
                jname = joint.get("name", "")
                stiffness.append(kp_map.get(jname, 0.0))
                damping.append(float(jg("damping", "0")))
                armature.append(float(jg("armature", "0.001")))
                mass.append(0.0)
                com.append(np.zeros(3))
                inertia.append(np.zeros((3, 3)))
                cur_parent = idx
                cur_pos = np.zeros(3)
                cur_quat = np.array([0, 0, 0, 1.0])

            bi = cur_parent  # the body carrying geometry = last joint body
            inert = body.find("inertial")
            geom_mass = 0.0
            for geom in body.findall("geom"):
                gg = lambda k, d: defaults.geom_get(geom, k, d, b_class)
                gtype = gg("type", "sphere")
                gpos = _parse_vec(geom.get("pos"), [0, 0, 0])
                size = _parse_vec(geom.get("size"), [0.005])
                # visual-only geoms (contype=0 + conaffinity=0, or a mesh)
                # generate no collision; primitives among them feed the
                # renderer
                visual_only = (
                    gtype == "mesh"
                    or (gg("contype", "1") == "0"
                        and gg("conaffinity", "1") == "0")
                )
                if visual_only:
                    if gtype == "sphere":
                        vgeoms.append(("sphere", bi, gpos, float(size[0])))
                    elif gtype == "capsule":
                        fromto = _parse_vec(geom.get("fromto"))
                        r = float(size[0])
                        if fromto is not None:
                            a, b = fromto[:3], fromto[3:]
                        else:
                            half = size[1] if len(size) > 1 else r
                            a = gpos - np.array([0, 0, half])
                            b = gpos + np.array([0, 0, half])
                        vgeoms.append(("capsule", bi, a, b, r))
                    elif gtype == "box":
                        vgeoms.append((
                            "box", bi, gpos, _orient(geom),
                            np.asarray(size[:3], dtype=np.float64),
                        ))
                    # a mesh's vertices live in the asset file: skipped
                elif gtype == "sphere":
                    spheres.append((bi, gpos, float(size[0])))
                elif gtype == "capsule":
                    fromto = _parse_vec(geom.get("fromto"))
                    r = float(size[0])
                    if fromto is not None:
                        a, b = fromto[:3], fromto[3:]
                    else:
                        half = size[1] if len(size) > 1 else r
                        a = gpos - np.array([0, 0, half])
                        b = gpos + np.array([0, 0, half])
                    for t in (0.0, 0.5, 1.0):
                        spheres.append((bi, a + t * (b - a), r))
                elif gtype == "box":
                    r = float(min(size))
                    spheres.append((bi, gpos, r))
                gm = geom.get("mass")
                if gm is not None:
                    geom_mass += float(gm)
            if inert is not None:
                mass[bi] = float(inert.get("mass", "0"))
                com[bi] = _parse_vec(inert.get("pos"), [0, 0, 0])
                full = _parse_vec(inert.get("fullinertia"))
                if full is not None:
                    # MJCF order: ixx iyy izz ixy ixz iyz
                    ixx, iyy, izz, ixy, ixz, iyz = full
                    inertia[bi] = np.array([
                        [ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]
                    ])
                else:
                    diag = _parse_vec(inert.get("diaginertia"), [1e-6] * 3)
                    ine = np.diag(diag)
                    # principal-axes orientation: rotate into the body frame
                    iq = inert.get("quat")
                    if iq is not None:
                        R = _quat_to_mat_np(_orient(inert))
                        ine = R @ ine @ R.T
                    inertia[bi] = ine
            elif geom_mass > 0:
                mass[bi] = geom_mass
                inertia[bi] = np.eye(3) * max(geom_mass * 1e-4, 1e-7)

            for site in body.findall("site"):
                sites.append((
                    site.get("name", f"site{len(sites)}"),
                    bi,
                    _parse_vec(site.get("pos"), [0, 0, 0]),
                    _orient(site),
                ))

            walk(body, cur_parent, np.zeros(3), np.array([0, 0, 0, 1.0]),
                 b_class)

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError(f"MJCF has no <worldbody>: {path}")
    walk(worldbody, -1, np.zeros(3), np.array([0, 0, 0, 1.0]))

    if not body_names:
        raise ValueError(f"MJCF has no articulated bodies: {path}")

    return HandModel(
        body_names=body_names,
        parent=np.asarray(parent, dtype=np.int32),
        joint_type=np.asarray(joint_type, dtype=np.int32),
        axis=np.stack(axis),
        attach_pos=np.stack(attach_pos),
        attach_quat=np.stack(attach_quat),
        post_quat=np.stack(post_quat),
        mass=np.asarray(mass),
        com=np.stack(com),
        inertia=np.stack(inertia),
        lower_limit=np.asarray(lower),
        upper_limit=np.asarray(upper),
        stiffness=np.asarray(stiffness),
        damping=np.asarray(damping),
        armature=np.asarray(armature),
        site_names=[s[0] for s in sites],
        site_body=np.asarray([s[1] for s in sites], dtype=np.int32),
        site_pos=(np.stack([s[2] for s in sites]) if sites else np.zeros((0, 3))),
        site_quat=(np.stack([s[3] for s in sites]) if sites else np.zeros((0, 4))),
        sphere_body=np.asarray([s[0] for s in spheres], dtype=np.int32),
        sphere_pos=(np.stack([s[1] for s in spheres]) if spheres
                    else np.zeros((0, 3))),
        sphere_radius=np.asarray([s[2] for s in spheres]),
        visual_geoms=vgeoms,
    )


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix from an xyzw quaternion (numpy, load time only)."""
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _quat_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])
