"""Host-side scene renderer: one env's state -> an RGB frame.

The port's counterpart of `dexrobot_isaac_tpu/graphics/renderer.py`.
Rendering stays off the step: the step runs on the card, and a frame is
drawn on the host, in numpy, from the state the step returns. `env_rows`
takes the FK of the one env to draw on its device and moves its rows to
the host in one copy; `SceneRenderer.render_state` draws them with the
rasterizer (graphics/raster.py): the hand's visual geometry
(`HandModel.visual_geoms`: shaded capsules, boxes, spheres per body) or,
without it, its collision spheres with interpolated spheres along each
finger; the box, the second box of two-box scenes, a checkered ground, and
the contacted bodies tinted red. The same poses give the same frame, bit
for bit, as the JAX package's renderer. On the host of an NVIDIA H100 80GB
HBM3 at 700 W a 640x480 frame at 4096 envs takes 27.6 ms of `env_rows` (the
FK's small launches bound it) and 27.6 ms of rasterizing (`chip_smoke.py`
`[graphics]`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.graphics.raster import Rasterizer
from dexrobot_isaac_tpu_torch.models.dexhand021 import HandModel, build_hand_model

_HAND_COLOR = np.array([0.62, 0.64, 0.70])
_TIP_COLOR = np.array([0.78, 0.79, 0.84])
_CONTACT_RED = np.array([1.0, 0.25, 0.2])
BOX2_COLOR = (0.92, 0.62, 0.25)


def _quat_rotate_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """numpy twin of ops/quat.quat_rotate (xyzw)."""
    qvec, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(qvec, v)
    return v + qw * t + np.cross(qvec, t)


def _quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return np.array([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ])


@dataclasses.dataclass
class EnvRows:
    """One env's state on the host, what a frame needs (float32 numpy)."""

    body_pos: np.ndarray                    # (B, 3) FK body positions
    body_quat: np.ndarray                   # (B, 4)
    box_pos: np.ndarray                     # (3,)
    box_quat: np.ndarray                    # (4,)
    contact_force: Optional[np.ndarray]     # (B, 3) or None
    box2_pos: Optional[np.ndarray] = None   # (3,) in two-box scenes
    box2_quat: Optional[np.ndarray] = None  # (4,)

    @staticmethod
    def select(kin, physics, body_contact_force, e: int) -> "EnvRows":
        """Env `e`'s rows of states that hold every env (leading dim N;
        numpy arrays or tensors)."""
        row = lambda x: None if x is None else (
            x[e].cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x[e]))
        return EnvRows(row(kin.body_pos), row(kin.body_quat), row(physics.box_pos),
                       row(physics.box_quat), row(body_contact_force),
                       row(physics.box2_pos), row(physics.box2_quat))

    def render(self, renderer: "SceneRenderer", title: str, has_box: bool = True,
               contacts: bool = True, box2_size: Optional[float] = None) -> np.ndarray:
        """The frame of these rows: the box where `has_box`, the contacted
        bodies tinted where `contacts`, the second box where there is one."""
        cf = (np.linalg.norm(self.contact_force, axis=-1)
              if contacts and self.contact_force is not None else None)
        return renderer.render_state(
            self.body_pos, self.body_quat, box_pos=self.box_pos if has_box else None,
            box_quat=self.box_quat, contact_force_bodies=cf, title=title,
            box2_pos=self.box2_pos, box2_quat=self.box2_quat, box2_size=box2_size)


def env_rows(engine, physics, spawn: torch.Tensor, body_contact_force, e: int) -> EnvRows:
    """Env `e`'s rows from the env's state on its device: the FK of env `e`
    alone (`engine.fk` of its q and qd rows at `spawn`, the (3,) spawn
    position), then one host copy of its body poses, box rows and contact
    forces. FK is independent per env, so these are the rows of the FK of
    every env."""
    s = slice(e, e + 1)
    kin = engine.fk(physics.q[s], physics.qd[s], spawn.reshape(1, 3))
    parts = [kin.body_pos[0], kin.body_quat[0], physics.box_pos[e], physics.box_quat[e]]
    if body_contact_force is not None:
        parts.append(body_contact_force[e])
    if physics.box2_pos is not None:
        parts += [physics.box2_pos[e], physics.box2_quat[e]]
    flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
    out = np.split(flat, np.cumsum([p.numel() for p in parts])[:-1])
    out = [o.reshape(p.shape) for o, p in zip(out, parts)]
    force = out.pop(4) if body_contact_force is not None else None
    return EnvRows(*out[:4], force, *out[4:])


class SceneRenderer:
    def __init__(
        self,
        model: Optional[HandModel] = None,
        resolution: Tuple[int, int] = (640, 480),
        box_size: float = 0.05,
        box_color=(0.45, 0.68, 0.95),   # cfg task.visualization.box_color
        camera_pos=(0.7, -0.7, 0.55),
        camera_target=(0.05, 0.0, 0.15),
    ):
        self.model = model or build_hand_model()
        self.resolution = tuple(resolution)
        self.box_size = box_size
        self.box_color = tuple(box_color)
        self.camera_pos = np.asarray(camera_pos, dtype=np.float64)
        self.camera_target = np.asarray(camera_target, dtype=np.float64)
        self._r = Rasterizer(self.resolution)
        # finger joint chains for the capsule fill (built once)
        self._chains = [
            [self.model.body_index(f"r_f_link{f}_{j}") for j in range(1, 5)]
            for f in range(1, 6)
        ]
        self._tip_bodies = {c[-1] for c in self._chains}
        # visual link geometry; empty => the collision-impostor fallback
        self._vgeoms = list(getattr(self.model, "visual_geoms", []) or [])

    def render_state(
        self,
        kin_body_pos: np.ndarray,     # (B, 3) one env's FK body positions
        kin_body_quat: np.ndarray,    # (B, 4)
        box_pos: Optional[np.ndarray] = None,
        box_quat: Optional[np.ndarray] = None,
        contact_force_bodies: Optional[np.ndarray] = None,  # (B,) magnitudes
        title: str = "",
        box2_pos: Optional[np.ndarray] = None,   # second free body
        box2_quat: Optional[np.ndarray] = None,  # (multi-object scenes)
        box2_size: Optional[float] = None,
    ) -> np.ndarray:
        """Render one env's state to an RGB uint8 frame (H, W, 3)."""
        r = self._r
        r.begin(self.camera_pos, self.camera_target)
        m = self.model
        body_pos = np.asarray(kin_body_pos, np.float64)

        if not self._vgeoms:
            # collision spheres in world (impostor fallback only)
            sb = np.asarray(m.sphere_body)
            centers = body_pos[sb] + _quat_rotate_np(
                np.asarray(kin_body_quat, dtype=np.float64)[sb],
                np.asarray(m.sphere_pos, dtype=np.float64),
            )
            radii = np.asarray(m.sphere_radius, np.float64)
            colors = np.where(
                np.isin(sb, list(self._tip_bodies))[:, None],
                _TIP_COLOR, _HAND_COLOR,
            ).astype(np.float64)
            if contact_force_bodies is not None:
                f = np.asarray(contact_force_bodies, np.float64)[sb]
                t = np.clip(f / 10.0, 0.0, 1.0)[:, None]
                hot = f[:, None] > 0.1
                colors = np.where(
                    hot, _CONTACT_RED * t + colors * (1 - t), colors
                )

        if self._vgeoms:
            # visual link geometry per body pose, with the same contact
            # tinting as the impostor path
            quat = np.asarray(kin_body_quat, dtype=np.float64)
            cf = (
                np.asarray(contact_force_bodies, np.float64)
                if contact_force_bodies is not None else None
            )
            for g in self._vgeoms:
                kind, b = g[0], int(g[1])
                col = _TIP_COLOR if b in self._tip_bodies else _HAND_COLOR
                if cf is not None and cf[b] > 0.1:
                    t = min(cf[b] / 10.0, 1.0)
                    col = _CONTACT_RED * t + col * (1 - t)
                Rb = _quat_to_rotmat_np(quat[b])
                if kind == "capsule":
                    _, _, p0, p1, rad = g
                    w0 = body_pos[b] + Rb @ np.asarray(p0, np.float64)
                    w1 = body_pos[b] + Rb @ np.asarray(p1, np.float64)
                    r.capsule(w0, w1, float(rad), col)
                elif kind == "box":
                    _, _, c0, gq, half = g
                    Rg = Rb @ _quat_to_rotmat_np(np.asarray(gq, np.float64))
                    r.box(
                        body_pos[b] + Rb @ np.asarray(c0, np.float64),
                        Rg, np.asarray(half, np.float64), col,
                    )
                elif kind == "sphere":
                    _, _, c0, rad = g
                    r.spheres(
                        (body_pos[b] + Rb @ np.asarray(c0, np.float64))[None],
                        np.array([float(rad)]), np.asarray(col)[None],
                    )
        else:
            # collision-impostor fallback: interpolated spheres between
            # consecutive joints of each finger chain
            extra_c, extra_r, extra_col = [centers], [radii], [colors]
            for chain in self._chains:
                for a, b in zip(chain[:-1], chain[1:]):
                    pa, pb = body_pos[a], body_pos[b]
                    seg = np.linalg.norm(pb - pa)
                    if seg < 1e-6:
                        continue
                    k = max(int(seg / 0.006), 2)
                    ts = np.linspace(0.0, 1.0, k + 2)[1:-1, None]
                    extra_c.append(pa + ts * (pb - pa))
                    extra_r.append(np.full(len(ts), 0.0075))
                    extra_col.append(np.tile(_HAND_COLOR, (len(ts), 1)))
            r.spheres(
                np.concatenate(extra_c), np.concatenate(extra_r),
                np.concatenate(extra_col),
            )

        if box_pos is not None:
            self._draw_box(np.asarray(box_pos), np.asarray(box_quat))
        if box2_pos is not None:
            self._draw_box(
                np.asarray(box2_pos), np.asarray(box2_quat),
                size=box2_size, color=BOX2_COLOR,
            )
        r.ground()
        frame = r.finish()
        if title:
            frame = self._stamp_title(frame, title)
        return frame

    def _draw_box(self, pos, quat, size=None, color=None):
        h = (self.box_size if size is None else size) / 2
        R = _quat_to_rotmat_np(np.asarray(quat, dtype=np.float64))
        self._r.box(
            pos, R, (h, h, h),
            np.asarray(self.box_color if color is None else color),
        )

    @staticmethod
    def _stamp_title(frame: np.ndarray, title: str) -> np.ndarray:
        try:
            import cv2

            frame = frame.copy()
            cv2.putText(
                frame, title, (8, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                (235, 235, 240), 1, cv2.LINE_AA,
            )
        except Exception:
            pass
        return frame

    def close(self):
        pass
