"""Generate the vendored DexHand021 MJCF from the port's model spec (the port
of `tools/gen_dexhand_mjcf.py`).

    python -m dexrobot_isaac_tpu_torch.tools.gen_dexhand_mjcf <out.xml>

Emits the MJCF of `models/dexhand021.py` `build_hand_model()` (the
doc-reconstructed 26-DOF hand: nested body chains, per-joint ranges, damping
and armature, oriented inertials, collision-sphere geoms, fingertip and pad
sites, position actuators), byte for byte the committed
`dexrobot_isaac_tpu/assets/dexhand021_right_simplified_floating.xml`, into
the path the caller names (the JAX tool writes that file itself).

MJCF has no post-joint rotation, so the model's
  T(attach_pos, attach_quat) * J(axis, q) * T(0, post_quat)
is written in native MJCF form as
  body quat = attach_quat * post_quat,  joint axis = post_quat^-1 * axis
an algebraically identical kinematic chain in another parameterization.
"""

from __future__ import annotations

import os
import sys
from xml.dom import minidom
from xml.etree import ElementTree as ET

import numpy as np

from dexrobot_isaac_tpu_torch.models.dexhand021 import (
    PRISMATIC,
    _quat_from_mat,
    build_hand_model,
)
from dexrobot_isaac_tpu_torch.models.mjcf import _quat_mul_np, _quat_to_mat_np


def _fmt(a) -> str:
    return " ".join(f"{float(x):.17g}" for x in np.atleast_1d(a))


def _wxyz(q_xyzw) -> str:
    x, y, z, w = q_xyzw
    return _fmt([w, x, y, z])


def _qrot_inv_np(q, v):
    return _quat_to_mat_np(np.asarray(q)).T @ np.asarray(v)


def mjcf_xml() -> str:
    """The vendored MJCF's text, from `build_hand_model()`."""
    m = build_hand_model()
    B = m.num_bodies
    children = [[] for _ in range(B)]
    roots = []
    for i in range(B):
        p = int(m.parent[i])
        (children[p] if p >= 0 else roots).append(i)

    root = ET.Element("mujoco", model="dexhand021_right_simplified_floating")
    ET.SubElement(root, "compiler", angle="radian")
    worldbody = ET.SubElement(root, "worldbody")
    actuator = ET.SubElement(root, "actuator")

    sites_by_body = {}
    for s in range(m.num_sites):
        sites_by_body.setdefault(int(m.site_body[s]), []).append(s)
    spheres_by_body = {}
    for c in range(len(m.sphere_radius)):
        spheres_by_body.setdefault(int(m.sphere_body[c]), []).append(c)

    def emit(parent_elem, i):
        body_quat = _quat_mul_np(m.attach_quat[i], m.post_quat[i])
        body = ET.SubElement(
            parent_elem, "body", name=m.body_names[i],
            pos=_fmt(m.attach_pos[i]), quat=_wxyz(body_quat),
        )
        jtype = "slide" if m.joint_type[i] == PRISMATIC else "hinge"
        j_axis = _qrot_inv_np(m.post_quat[i], m.axis[i])
        ET.SubElement(
            body, "joint", name=m.dof_names[i], type=jtype,
            axis=_fmt(j_axis), limited="true",
            range=_fmt([m.lower_limit[i], m.upper_limit[i]]),
            damping=f"{float(m.damping[i]):.17g}",
            armature=f"{float(m.armature[i]):.17g}",
        )
        if m.mass[i] > 0:
            # principal-axes form: eigendecompose the (possibly oriented)
            # body-frame inertia tensor
            evals, evecs = np.linalg.eigh(m.inertia[i])
            if np.linalg.det(evecs) < 0:
                evecs[:, 0] = -evecs[:, 0]
            ET.SubElement(
                body, "inertial", mass=f"{float(m.mass[i]):.17g}",
                pos=_fmt(m.com[i]), quat=_wxyz(_quat_from_mat(evecs)),
                diaginertia=_fmt(np.maximum(evals, 0.0)),
            )
        for c in spheres_by_body.get(i, []):
            ET.SubElement(
                body, "geom", type="sphere", pos=_fmt(m.sphere_pos[c]),
                size=f"{float(m.sphere_radius[c]):.17g}",
            )
        for s in sites_by_body.get(i, []):
            ET.SubElement(
                body, "site", name=m.site_names[s],
                pos=_fmt(m.site_pos[s]), quat=_wxyz(m.site_quat[s]),
            )
        for ch in children[i]:
            emit(body, ch)

    for r in roots:
        emit(worldbody, r)
    for i in range(B):
        if m.stiffness[i] > 0:
            ET.SubElement(
                actuator, "position", joint=m.dof_names[i],
                kp=f"{float(m.stiffness[i]):.17g}",
            )

    return minidom.parseString(ET.tostring(root)).toprettyxml(indent="  ")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 2
    out = argv[0]
    xml = mjcf_xml()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(xml)
    m = build_hand_model()
    print(f"wrote {out} ({m.num_bodies} bodies, {m.num_sites} sites, "
          f"{len(m.sphere_radius)} collision spheres)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
