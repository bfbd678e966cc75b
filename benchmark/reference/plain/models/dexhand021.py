"""DexHand021 right-hand model (26 DOFs), the port's copy.

Numpy only: `build_hand_model` returns the same arrays as
`dexrobot_isaac_tpu/models/dexhand021.py` (a test holds the two equal). The
port imports nothing of the JAX package, so it keeps this copy. The model
is reconstructed from the upstream documentation: 26 DOFs, a floating base
driven by ARTx/y/z + ARRx/y/z, a built-in Ry(90 deg) on the palm, 20 finger
links, fingertip/fingerpad sites and collision spheres.

Kinematic convention (reduced coordinates, one 1-DOF joint per body):

    X_world(body i) = X_world(parent) * T(attach_pos, attach_quat)
                      * J(joint_type, axis, q_i) * T(0, post_quat)

Bodies 0-4 are massless virtual links of the floating-base chain, body 5 is
`right_hand_base` (the palm), bodies 6-25 the finger links.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np

from benchmark.reference.plain.constants import (
    BASE_JOINT_NAMES,
    DOF_NAMES,
    FINGER_JOINT_NAMES,
    FINGERPAD_BODY_NAMES,
    FINGERTIP_BODY_NAMES,
    NUM_BASE_DOFS,
    NUM_DOFS,
)

PRISMATIC = 0
REVOLUTE = 1

# World->local conversion for frames attached to the palm body. The palm body
# frame carries the built-in Ry(90 deg): local = Ry(-90) * world.
_RY_M90 = np.array([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])


def _w2l(v) -> np.ndarray:
    """Map a world-frame vector (at q=0) into the palm body local frame."""
    return _RY_M90 @ np.asarray(v, dtype=np.float64)


def _quat_from_mat(m: np.ndarray) -> np.ndarray:
    """xyzw quaternion from a 3x3 rotation matrix (numpy, model build only)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s, 0.25 * s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


_QUAT_ID = np.array([0.0, 0.0, 0.0, 1.0])
_QUAT_RY90 = np.array([0.0, np.sqrt(0.5), 0.0, np.sqrt(0.5)])
_QUAT_RY_M90 = np.array([0.0, -np.sqrt(0.5), 0.0, np.sqrt(0.5)])
# Finger root frames expressed in the palm local frame: main fingers are
# world-aligned at q=0 => local attach orientation Ry(-90). The thumb root is
# additionally yawed +90 deg so the thumb lies along world +Y.
_RZ90 = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
_QUAT_FINGER_ROOT = _QUAT_RY_M90
_QUAT_THUMB_ROOT = _quat_from_mat(_RY_M90 @ _RZ90)


@dataclasses.dataclass(frozen=True)
class HandModel:
    """Static description of the articulated hand; all arrays are numpy.

    Per-DOF/body arrays have length ``num_bodies`` (= NUM_DOFS: one joint per
    body). Consumed at trace time by the physics engine; never traced itself.
    """

    body_names: List[str]
    parent: np.ndarray          # (B,) int, -1 for world
    joint_type: np.ndarray      # (B,) int, PRISMATIC | REVOLUTE
    axis: np.ndarray            # (B, 3) joint axis in joint frame
    attach_pos: np.ndarray      # (B, 3) fixed offset in parent body frame
    attach_quat: np.ndarray     # (B, 4) fixed rotation in parent body frame
    post_quat: np.ndarray       # (B, 4) fixed rotation after joint motion
    mass: np.ndarray            # (B,)
    com: np.ndarray             # (B, 3) center of mass in body frame
    inertia: np.ndarray         # (B, 3, 3) rotational inertia about com
    lower_limit: np.ndarray     # (B,)
    upper_limit: np.ndarray     # (B,)
    stiffness: np.ndarray       # (B,) PD kp
    damping: np.ndarray         # (B,) PD kd (+ passive joint damping)
    armature: np.ndarray        # (B,) added reflected inertia
    # Massless frames attached to bodies (fingertips, fingerpads).
    site_names: List[str]
    site_body: np.ndarray       # (S,) int
    site_pos: np.ndarray        # (S, 3)
    site_quat: np.ndarray       # (S, 4)
    # Collision spheres for contact generation.
    sphere_body: np.ndarray     # (C,) int
    sphere_pos: np.ndarray      # (C, 3)
    sphere_radius: np.ndarray   # (C,)
    # Visual geometry for the renderer (graphics/renderer.py), in body frame:
    #   ("capsule", body, p0 (3,), p1 (3,), radius)
    #   ("box", body, center (3,), quat (4,), half_extents (3,))
    #   ("sphere", body, center (3,), radius)
    # Empty: the renderer draws the collision spheres instead.
    visual_geoms: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def num_bodies(self) -> int:
        return len(self.body_names)

    @property
    def num_sites(self) -> int:
        return len(self.site_names)

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)

    def site_index(self, name: str) -> int:
        return self.site_names.index(name)

    @property
    def dof_names(self) -> List[str]:
        return list(DOF_NAMES)


# Finger layout at q=0, in world coordinates relative to the hand base origin.
# (base_attach_point, root_quat, link_lengths[4])
# Main fingers: chain extends along the root frame +X; flexion about +Y curls
# the finger toward -Z (the palm normal / "down" at q=0).
_FINGER_GEOM: Dict[int, Tuple[np.ndarray, np.ndarray, List[float]]] = {
    # thumb: base on the +Y edge of the palm, thumb along +Y at q=0
    1: (np.array([0.020, 0.048, -0.012]), _QUAT_THUMB_ROOT,
        [0.022, 0.042, 0.032, 0.030]),
    # index
    2: (np.array([0.078, 0.032, -0.008]), _QUAT_FINGER_ROOT,
        [0.012, 0.046, 0.030, 0.026]),
    # middle
    3: (np.array([0.082, 0.010, -0.008]), _QUAT_FINGER_ROOT,
        [0.012, 0.050, 0.032, 0.027]),
    # ring
    4: (np.array([0.078, -0.012, -0.008]), _QUAT_FINGER_ROOT,
        [0.012, 0.046, 0.030, 0.026]),
    # pinky
    5: (np.array([0.070, -0.034, -0.008]), _QUAT_FINGER_ROOT,
        [0.012, 0.038, 0.026, 0.024]),
}

# Spread-joint axes (joint f_1) in the finger root frame: rotation about +/-Z
# swings the finger laterally in the palm plane; signs chosen so positive
# spread moves index away from middle (+Y world) and ring/pinky away (-Y).
# The thumb "spread" (r_f_joint1_1, range 0..2.2) is the opposition roll about
# the root +Y axis, matching the reference's thumb-rotation semantics
# (BlindGrasping rewards r_f_joint1_1 near pi/2; blind_grasping_task.py:1100-1110).
_SPREAD_AXIS: Dict[int, np.ndarray] = {
    1: np.array([0.0, 1.0, 0.0]),
    2: np.array([0.0, 0.0, 1.0]),
    3: np.array([0.0, 0.0, 1.0]),   # fixed joint (range [0, 0])
    4: np.array([0.0, 0.0, -1.0]),
    5: np.array([0.0, 0.0, -1.0]),
}

_FLEX_AXIS = np.array([0.0, 1.0, 0.0])

# Joint limits reconstructed per docs (spread neutral 0.15 / full 0.3 rad with
# pinky 2x: reference-dof-control-api.md:140-156; DIP range 0-1.3:
# examples/dexhand_test.py:209-218; thumb rotation >= pi/2: BlindGrasping
# thumb_rotation_range cfg).
_FINGER_LIMITS: Dict[str, Tuple[float, float]] = {}
for _f in range(1, 6):
    _FINGER_LIMITS[f"r_f_joint{_f}_2"] = (0.0, 1.3)
    _FINGER_LIMITS[f"r_f_joint{_f}_3"] = (0.0, 1.3)
    _FINGER_LIMITS[f"r_f_joint{_f}_4"] = (0.0, 1.3)
_FINGER_LIMITS["r_f_joint1_1"] = (0.0, 2.2)
_FINGER_LIMITS["r_f_joint2_1"] = (0.0, 0.3)
_FINGER_LIMITS["r_f_joint3_1"] = (0.0, 0.0)  # fixed
_FINGER_LIMITS["r_f_joint4_1"] = (0.0, 0.3)
_FINGER_LIMITS["r_f_joint5_1"] = (0.0, 0.6)  # 2x coupling scale

_BASE_LIMITS: Dict[str, Tuple[float, float]] = {
    "ARTx": (-1.0, 1.0),
    "ARTy": (-1.0, 1.0),
    "ARTz": (-1.0, 1.0),
    "ARRx": (-np.pi, np.pi),
    "ARRy": (-np.pi, np.pi),
    "ARRz": (-np.pi, np.pi),
}

_LINK_MASS = [0.015, 0.025, 0.018, 0.012]  # per finger link, proximal->distal
_PALM_MASS = 0.45
_FINGER_RADIUS = 0.009
_TIP_RADIUS = 0.008


def _rod_inertia(mass: float, length: float, radius: float) -> np.ndarray:
    """Inertia of a solid rod along +X about its COM."""
    ixx = 0.5 * mass * radius**2
    iyy = izz = mass * (3 * radius**2 + length**2) / 12.0
    return np.diag([ixx, iyy, izz])


@functools.lru_cache(maxsize=1)
def build_hand_model() -> HandModel:
    """Construct the canonical DexHand021 right-hand model."""
    B = NUM_DOFS
    body_names: List[str] = []
    parent = np.full(B, -1, dtype=np.int32)
    joint_type = np.zeros(B, dtype=np.int32)
    axis = np.zeros((B, 3))
    attach_pos = np.zeros((B, 3))
    attach_quat = np.tile(_QUAT_ID, (B, 1))
    post_quat = np.tile(_QUAT_ID, (B, 1))
    mass = np.zeros(B)
    com = np.zeros((B, 3))
    inertia = np.zeros((B, 3, 3))
    lower = np.zeros(B)
    upper = np.zeros(B)
    stiffness = np.zeros(B)
    damping = np.zeros(B)
    armature = np.zeros(B)

    # --- floating base chain (6 DOFs) ---
    base_axes = np.eye(3)
    for i, name in enumerate(BASE_JOINT_NAMES):
        body_names.append("right_hand_base" if i == 5 else f"{name}_link")
        parent[i] = i - 1
        joint_type[i] = PRISMATIC if i < 3 else REVOLUTE
        axis[i] = base_axes[i % 3]
        lower[i], upper[i] = _BASE_LIMITS[name]
        stiffness[i] = 10000.0
        damping[i] = 20.0
        armature[i] = 0.05
    # Palm: ARRz joint + built-in Ry(90 deg) post rotation
    post_quat[5] = _QUAT_RY90
    mass[5] = _PALM_MASS
    com[5] = _w2l([0.040, 0.005, -0.010])
    # palm approximated as a box 0.10 x 0.09 x 0.03 (world x,y,z at q=0)
    pw = np.array([0.10, 0.09, 0.03])
    ibox = _PALM_MASS / 12.0 * np.array(
        [pw[1] ** 2 + pw[2] ** 2, pw[0] ** 2 + pw[2] ** 2, pw[0] ** 2 + pw[1] ** 2]
    )
    # rotate box inertia (world-diagonal) into palm local frame
    inertia[5] = _RY_M90 @ np.diag(ibox) @ _RY_M90.T

    # --- fingers ---
    sites: List[Tuple[str, int, np.ndarray, np.ndarray]] = []
    spheres: List[Tuple[int, np.ndarray, float]] = []
    # palm visual: the slab the inertia models, axis-aligned in world at q=0,
    # so Ry(-90) in the palm frame (which carries the built-in Ry(90))
    vgeoms: List[tuple] = [(
        "box", 5, _w2l([0.045, 0.005, -0.010]), _QUAT_RY_M90.copy(),
        np.array([0.045, 0.045, 0.015]),
    )]
    for f in range(1, 6):
        base_pt_w, root_quat, lengths = _FINGER_GEOM[f]
        for j in range(1, 5):
            name = f"r_f_joint{f}_{j}"
            bi = NUM_BASE_DOFS + FINGER_JOINT_NAMES.index(name)
            body_names.append(f"r_f_link{f}_{j}")
            joint_type[bi] = REVOLUTE
            L = lengths[j - 1]
            if j == 1:
                parent[bi] = 5  # palm
                attach_pos[bi] = _w2l(base_pt_w)
                attach_quat[bi] = root_quat
                axis[bi] = _SPREAD_AXIS[f]
            else:
                parent[bi] = bi - 1
                attach_pos[bi] = np.array([lengths[j - 2], 0.0, 0.0])
                axis[bi] = _FLEX_AXIS
            m = _LINK_MASS[j - 1]
            mass[bi] = m
            com[bi] = np.array([0.5 * L, 0.0, 0.0])
            inertia[bi] = _rod_inertia(m, L, _FINGER_RADIUS)
            lower[bi], upper[bi] = _FINGER_LIMITS[name]
            stiffness[bi] = 20.0
            damping[bi] = 1.0
            armature[bi] = 0.002
            # collision spheres along the link
            spheres.append((bi, np.array([0.5 * L, 0.0, 0.0]), _FINGER_RADIUS))
            # visual: the phalanx as a capsule along the link's +x rod
            vgeoms.append((
                "capsule", bi, np.zeros(3), np.array([L, 0.0, 0.0]),
                _TIP_RADIUS if j == 4 else _FINGER_RADIUS,
            ))
            if j == 4:
                # distal link: tip + pad spheres and sites
                tip_pos = np.array([L, 0.0, 0.0])
                pad_pos = np.array([0.55 * L, 0.0, -0.006])
                spheres.append((bi, tip_pos, _TIP_RADIUS))
                spheres.append((bi, pad_pos, _TIP_RADIUS))
                sites.append((FINGERTIP_BODY_NAMES[f - 1], bi, tip_pos, _QUAT_ID))
                sites.append((FINGERPAD_BODY_NAMES[f - 1], bi, pad_pos, _QUAT_ID))

    # palm collision spheres (palm slab spans x in [0, 0.09], y in [-0.04, 0.05],
    # z in [-0.025, 0.005] world at q=0)
    palm_r = 0.013
    for wx in (0.02, 0.05, 0.075):
        for wy in (-0.030, 0.0, 0.030):
            spheres.append((5, _w2l([wx, wy, -0.012]), palm_r))

    site_names = [s[0] for s in sites]
    model = HandModel(
        body_names=body_names,
        parent=parent,
        joint_type=joint_type,
        axis=axis,
        attach_pos=attach_pos,
        attach_quat=attach_quat,
        post_quat=post_quat,
        mass=mass,
        com=com,
        inertia=inertia,
        lower_limit=lower,
        upper_limit=upper,
        stiffness=stiffness,
        damping=damping,
        armature=armature,
        site_names=site_names,
        site_body=np.array([s[1] for s in sites], dtype=np.int32),
        site_pos=np.stack([s[2] for s in sites]),
        site_quat=np.stack([s[3] for s in sites]),
        sphere_body=np.array([s[0] for s in spheres], dtype=np.int32),
        sphere_pos=np.stack([s[1] for s in spheres]),
        sphere_radius=np.array([s[2] for s in spheres]),
        visual_geoms=vgeoms,
    )
    return model
