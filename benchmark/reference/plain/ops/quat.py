"""Batched quaternion / rotation math in torch (xyzw convention).

The port's counterpart of `dexrobot_isaac_tpu/ops/quat.py`, limited to the
ops the engine and the observations use. Every function broadcasts over
leading batch dimensions.
"""

from __future__ import annotations

import torch


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-9)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    qvec, qw = q[..., :3], q[..., 3:4]
    qvec, v = torch.broadcast_tensors(qvec, v)
    t = 2.0 * torch.linalg.cross(qvec, v)
    return v + qw * t + torch.linalg.cross(qvec, t)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conjugate(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    qx, qy, qz, qw = q.unbind(-1)
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """q' = normalize(q + 0.5 dt omega_quat * q) (world-frame omega)."""
    omega_quat = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    return quat_unit(q + 0.5 * dt * quat_mul(omega_quat, q))


def point_in_hand_frame(
    point_world: torch.Tensor, hand_pos: torch.Tensor, hand_quat: torch.Tensor
) -> torch.Tensor:
    return quat_rotate_inverse(hand_quat, point_world - hand_pos)
