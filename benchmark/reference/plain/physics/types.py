"""Physics state dataclasses and simulation parameters (torch).

The port's counterpart of `dexrobot_isaac_tpu/physics/types.py`: plain
dataclasses of tensors with the leading dim = num_envs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

DR_FIELDS = ("kp_scale", "kd_scale", "box_mass_scale", "friction_scale")


@dataclasses.dataclass
class PhysicsState:
    q: torch.Tensor            # (N, 26) joint positions
    qd: torch.Tensor           # (N, 26) joint velocities
    box_pos: torch.Tensor      # (N, 3)
    box_quat: torch.Tensor     # (N, 4) xyzw
    box_linvel: torch.Tensor   # (N, 3)
    box_angvel: torch.Tensor   # (N, 3)
    # the second free box (SimParams.has_box2); None in single-box scenes
    box2_pos: Optional[torch.Tensor] = None     # (N, 3)
    box2_quat: Optional[torch.Tensor] = None    # (N, 4) xyzw
    box2_linvel: Optional[torch.Tensor] = None  # (N, 3)
    box2_angvel: Optional[torch.Tensor] = None  # (N, 3)


BOX_FIELDS = ("box_pos", "box_quat", "box_linvel", "box_angvel")
BOX2_FIELDS = ("box2_pos", "box2_quat", "box2_linvel", "box2_angvel")


def box_rows(state: PhysicsState, has_box2: bool) -> torch.Tensor:
    """(N, 13), or (N, 26) with the second box: the kernels' box operand."""
    names = BOX_FIELDS + (BOX2_FIELDS if has_box2 else ())
    return torch.cat([getattr(state, k) for k in names], 1)


def from_box_rows(box: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of `box_rows`: {field: (N, k)} of the 13 or 26 columns."""
    names = BOX_FIELDS + (BOX2_FIELDS if box.shape[1] == 26 else ())
    out, o = {}, 0
    for k in names:
        w = 4 if k.endswith("quat") else 3
        out[k] = box[:, o:o + w]
        o += w
    return out


@dataclasses.dataclass
class KinematicsOut:
    body_pos: torch.Tensor     # (N, B, 3)
    body_quat: torch.Tensor    # (N, B, 4)
    body_linvel: torch.Tensor  # (N, B, 3)
    body_angvel: torch.Tensor  # (N, B, 3)
    dof_axis_w: torch.Tensor   # (N, B, 3)
    dof_origin_w: torch.Tensor  # (N, B, 3)
    site_pos: torch.Tensor     # (N, S, 3)
    site_quat: torch.Tensor    # (N, S, 4)


@dataclasses.dataclass
class DRSample:
    """Per-env domain-randomization scales; 1.0 = nominal."""

    kp_scale: torch.Tensor
    kd_scale: torch.Tensor
    box_mass_scale: torch.Tensor
    friction_scale: torch.Tensor

    @staticmethod
    def nominal(num_envs: int, device) -> "DRSample":
        return DRSample(*(torch.ones(num_envs, device=device) for _ in DR_FIELDS))

    @staticmethod
    def sample(
        gen: torch.Generator, num_envs: int, ranges: Dict[str, Tuple[float, float]]
    ) -> "DRSample":
        """Uniform in [lo, hi] per field; fields absent from `ranges` stay
        1.0. Draws on the generator's device."""
        out = {}
        for name in DR_FIELDS:
            lo, hi = ranges.get(name, (1.0, 1.0))
            u = torch.rand(num_envs, generator=gen, device=gen.device)
            out[name] = lo + (hi - lo) * u
        return DRSample(**out)

    def rows(self) -> torch.Tensor:
        """(4, N) float32 in DR_FIELDS order (the kernels' DR operand)."""
        return torch.stack([getattr(self, k) for k in DR_FIELDS]).float()


@dataclasses.dataclass(frozen=True)
class SimParams:
    dt: float = 0.005
    substeps: int = 4
    gravity: float = -9.81
    contact_stiffness: float = 8000.0
    contact_damping: float = 60.0
    friction_stiffness: float = 400.0
    contact_beta: float = 0.2
    max_depenetration_velocity: float = 0.2
    self_collision: bool = True
    has_box: bool = False
    box_size: float = 0.05
    box_mass: float = 0.1
    box_friction: float = 1.0
    # the second free box (requires has_box)
    has_box2: bool = False
    box2_size: float = 0.08
    box2_mass: float = 0.5
    box2_friction: float = 1.0
    hand_friction: float = 1.0
    ground_friction: float = 1.0
    # RNEA velocity-product (Coriolis/centrifugal) terms in the joint-space
    # dynamics; the lane kernels K1 and K2 do not carry them, so the control
    # step runs the engine's ops with the SPD-solve kernel K3
    coriolis: bool = False


def tree_map(fn, obj):
    """Apply fn to every tensor leaf of a (nested) dataclass/dict."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj, **{f.name: tree_map(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        )
    return obj

