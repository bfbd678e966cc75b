"""Batched articulated rigid-body simulator for the DexHand scenes (torch).

The port's plain counterpart of `dexrobot_isaac_tpu/physics/engine.py`: the
readable batched reference that the CUDA lane-physics kernel
(`physics/lane_step.py`, `csrc/lane_physics.cuh`) is held against, as the jnp
engine is for `physics/pallas_step.py` in the JAX package. One substep runs
forward kinematics over the 26-DOF tree, penalty contacts (hand spheres vs
ground, pruned finger self-collision pairs, spheres vs the free box, box
corners vs ground; with `SimParams.has_box2` also spheres vs the second box,
its corners vs ground and the symmetric cube-cube corner narrowphase), the
CRBA mass matrix, the implicit-PD solve (dense Cholesky here; the kernel
factors the sparse LTL), joint-limit projection and box integration, and
with `SimParams.coriolis` the RNEA velocity-product bias.

`make_control_step` is the control step the env runs: the lane-physics
kernel K2 (`physics/lane_step.py`), or with `SimParams.coriolis`, which K2
does not carry, this engine's own op sequence with the batched SPD solve K3
(`ops/linalg.py`) on a CUDA tensor, as the JAX package declines its kernel
there (`engine.py:1042-1045`).

Build-time model analysis (apparent contact masses, the self-collision pair
list) is the JAX package's numpy code, copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.plain.models.dexhand021 import (
    HandModel,
    PRISMATIC,
    build_hand_model,
)
from benchmark.reference.plain.ops import linalg
from benchmark.reference.plain.ops import quat as qm
from benchmark.reference.plain.physics.types import (
    BOX2_FIELDS,
    DRSample,
    KinematicsOut,
    PhysicsState,
    SimParams,
)
from benchmark.reference.plain.utils.device import resolve_device


@dataclasses.dataclass
class StepInfo:
    body_contact_force: torch.Tensor  # (N, B, 3) net contact force per hand body
    box_contact_force: torch.Tensor   # (N, 3) net contact force on the box
    # (N, 3) net contact force on the second box (SimParams.has_box2)
    box2_contact_force: torch.Tensor | None = None


# ----------------------------------------------------------------------
# build-time apparent contact inertia and self-collision pairs (numpy)
def _np_quat_to_rotmat(qv: np.ndarray) -> np.ndarray:
    x, y, z, w = qv
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _np_axis_angle_rotmat(axis: np.ndarray, th: float) -> np.ndarray:
    a = axis / (np.linalg.norm(axis) + 1e-12)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def compute_sphere_apparent_mass(model: HandModel) -> np.ndarray:
    """Per-collision-sphere apparent (operational-space) mass, numpy.

    The impulse clamp in the contact model bounds each contact force by the
    impulse that stops the approach velocity in one substep. Using the bare
    link mass there (~12 g fingertips) caps fingertip forces at ~0.2 N --
    less than a 0.1 kg object's weight -- so objects sink through and slide
    out of any grasp. The mechanically correct bound is the apparent mass at
    the contact point through the articulated chain, 1/max-eig(J M^-1 J^T),
    which the joint armature (0.002 kg m^2 at ~2 cm lever arms) pushes to
    kilograms. Evaluated at a spread of postures; per-sphere minimum is used
    (conservative = stable).
    """
    B = model.num_bodies
    poses = [np.zeros(26)]
    flexed = np.zeros(26)
    flexed[6] = 1.0          # thumb rotation
    for f in range(5):
        flexed[6 + 4 * f + 1: 6 + 4 * f + 4] = 0.8
    poses.append(flexed)
    curled = np.zeros(26)
    curled[6] = 1.8
    for f in range(5):
        curled[6 + 4 * f + 1: 6 + 4 * f + 4] = 1.25
    poses.append(curled)

    anc = np.zeros((B, B))
    for b in range(B):
        j = b
        while j >= 0:
            anc[j, b] = 1.0
            j = int(model.parent[j])

    m_app = np.full(len(model.sphere_body), np.inf)
    for q in poses:
        pos = np.zeros((B, 3))
        rot = np.zeros((B, 3, 3))
        axis_w = np.zeros((B, 3))
        origin_w = np.zeros((B, 3))
        for i in range(B):
            pidx = int(model.parent[i])
            if pidx < 0:
                pp, Rp = np.zeros(3), np.eye(3)
            else:
                pp, Rp = pos[pidx], rot[pidx]
            o = pp + Rp @ model.attach_pos[i]
            Rj = Rp @ _np_quat_to_rotmat(model.attach_quat[i])
            a_w = Rj @ model.axis[i]
            if model.joint_type[i] == PRISMATIC:
                bp, Rb = o + a_w * q[i], Rj
            else:
                bp = o
                Rb = Rj @ _np_axis_angle_rotmat(model.axis[i], q[i])
            Rb = Rb @ _np_quat_to_rotmat(model.post_quat[i])
            pos[i], rot[i] = bp, Rb
            axis_w[i], origin_w[i] = a_w, o

        # CRBA about world origin (numpy mirror of HandPhysics.mass_matrix)
        prism = model.joint_type == PRISMATIC
        S = np.zeros((B, 6))
        S[:, :3] = np.where(prism[:, None], 0.0, axis_w)
        S[:, 3:] = np.where(
            prism[:, None], axis_w, np.cross(origin_w, axis_w)
        )
        com_w = pos + np.einsum("bij,bj->bi", rot, model.com)
        i_c = np.einsum("bij,bjk,blk->bil", rot, model.inertia, rot)
        i_o = np.zeros((B, 6, 6))
        for i in range(B):
            cx = np.array([
                [0, -com_w[i, 2], com_w[i, 1]],
                [com_w[i, 2], 0, -com_w[i, 0]],
                [-com_w[i, 1], com_w[i, 0], 0],
            ])
            mm = model.mass[i]
            i_o[i, :3, :3] = i_c[i] - mm * cx @ cx
            i_o[i, :3, 3:] = mm * cx
            i_o[i, 3:, :3] = -mm * cx
            i_o[i, 3:, 3:] = mm * np.eye(3)
        ic = i_o.copy()
        for i in reversed(range(B)):
            pidx = int(model.parent[i])
            if pidx >= 0:
                ic[pidx] += ic[i]
        f = np.einsum("bij,bj->bi", ic, S)
        raw = S @ f.T
        am = raw * anc
        M = am + am.T - np.diag(np.diag(raw)) + np.diag(model.armature)

        sb = np.asarray(model.sphere_body)
        sp = pos[sb] + np.einsum("bij,bj->bi", rot[sb], model.sphere_pos)
        Minv = np.linalg.inv(M)
        for c in range(len(sb)):
            J = np.zeros((3, B))
            for j in range(B):
                if not anc[j, sb[c]]:
                    continue
                if prism[j]:
                    J[:, j] = axis_w[j]
                else:
                    J[:, j] = np.cross(axis_w[j], sp[c] - origin_w[j])
            W = J @ Minv @ J.T
            lam = float(np.linalg.eigvalsh(W)[-1])
            m_app[c] = min(m_app[c], 1.0 / max(lam, 1e-9))
    return np.maximum(m_app, np.maximum(model.mass[model.sphere_body], 0.01))


def _np_fk_pose(model: HandModel, q: np.ndarray):
    """Position-only numpy FK (base at origin): (body_pos (B,3), body_rot (B,3,3))."""
    B = model.num_bodies
    pos = np.zeros((B, 3))
    rot = np.zeros((B, 3, 3))
    for i in range(B):
        pidx = int(model.parent[i])
        if pidx < 0:
            pp, Rp = np.zeros(3), np.eye(3)
        else:
            pp, Rp = pos[pidx], rot[pidx]
        o = pp + Rp @ model.attach_pos[i]
        Rj = Rp @ _np_quat_to_rotmat(model.attach_quat[i])
        if model.joint_type[i] == PRISMATIC:
            bp, Rb = o + (Rj @ model.axis[i]) * q[i], Rj
        else:
            bp = o
            Rb = Rj @ _np_axis_angle_rotmat(model.axis[i], q[i])
        pos[i] = bp
        rot[i] = Rb @ _np_quat_to_rotmat(model.post_quat[i])
    return pos, rot


def sphere_finger_ids(model: HandModel) -> np.ndarray:
    """Finger index (0..4) per collision sphere; -1 for palm/arm spheres.
    A sphere's finger is the child-of-palm subtree its body lives in, derived
    from the tree (finger roots are the children of `right_hand_base`)."""
    palm = 5  # right_hand_base (constants.py body ordering)
    fid_body = -np.ones(model.num_bodies, dtype=np.int64)
    roots: list = []
    for b in range(model.num_bodies):
        j = b
        while j >= 0 and int(model.parent[j]) != palm:
            j = int(model.parent[j])
        if j >= 0:
            if j not in roots:
                roots.append(j)
            fid_body[b] = roots.index(j)
    return fid_body[np.asarray(model.sphere_body)]


_PAIRS_CACHE: dict = {}


def compute_self_collision_pairs(
    model: HandModel, margin: float = 0.004
) -> np.ndarray:
    """`_probe_self_collision_pairs`, once per model and margin in a process
    (a few seconds of numpy FK probes; every env of the same hand reuses
    them)."""
    key = (margin,) + tuple(np.ascontiguousarray(getattr(model, f)).tobytes() for f in (
        "parent", "joint_type", "axis", "attach_pos", "attach_quat", "post_quat",
        "lower_limit", "upper_limit", "sphere_body", "sphere_pos", "sphere_radius"))
    if key not in _PAIRS_CACHE:
        _PAIRS_CACHE[key] = _probe_self_collision_pairs(model, margin)
    return _PAIRS_CACHE[key].copy()


def _probe_self_collision_pairs(model: HandModel, margin: float) -> np.ndarray:
    """Static broadphase at model-build time: the (P, 2) sphere pairs that can
    geometrically collide, found by probing joint-limit extremes with numpy FK.

    A runtime broadphase is useless when every env runs the same program
    (each env would still pay for every pair), so all pruning happens here,
    once, on the host. Candidates are cross-finger pairs on adjacent fingers plus
    thumb-vs-any (non-adjacent parallel fingers are blocked by the finger
    between them); a candidate survives if some probe pose over the two
    fingers' abduction x flexion extremes brings it within `margin` of
    touching. The surviving list is handed to both the plain engine and the
    kernel's model buffer.
    """
    fid = sphere_finger_ids(model)
    sb = np.asarray(model.sphere_body)
    r = np.asarray(model.sphere_radius)
    nf = int(fid.max()) + 1
    # joints of finger f: bodies 6+4f .. 6+4f+3 (joint index == body index)
    fingers = [list(range(6 + 4 * f, 6 + 4 * f + 4)) for f in range(nf)]

    def finger_probe_qs(f: int):
        """Representative joint vectors for finger f: abduction/rotation
        (joint 0) at limits x flexion (joints 1-3) at graded closures.
        Palm (f == -1) has no joints: a single empty config."""
        if f < 0:
            return [np.zeros(0)]
        j0 = fingers[f][0]
        lo, hi = model.lower_limit[j0], model.upper_limit[j0]
        out = []
        for abd in (lo, 0.5 * (lo + hi), hi):
            for flex in (0.0, 0.35, 0.6, 0.8, 1.0):
                qf = np.zeros(4)
                qf[0] = abd
                for k, j in enumerate(fingers[f][1:]):
                    qf[k + 1] = (
                        model.lower_limit[j]
                        + flex * (model.upper_limit[j] - model.lower_limit[j])
                    )
                out.append(qf)
        return out

    probes = {f: finger_probe_qs(f) for f in list(range(nf)) + [-1]}
    # candidate group pairs: every pair of distinct fingers plus each finger
    # vs the palm (fingers curl into the palm at full flexion). Geometric
    # impossibilities (e.g. thumb vs other fingers in this model) are removed
    # by the probe below, not by hand-picked adjacency rules.
    cand = [(fa, fb) for fa in range(nf) for fb in range(fa + 1, nf)]
    cand += [(f, -1) for f in range(nf)]
    pairs = []
    for fa, fb in cand:
        ia = np.nonzero(fid == fa)[0]
        ib = np.nonzero(fid == fb)[0]
        best = np.full((len(ia), len(ib)), np.inf)
        for qa in probes[fa]:
            for qb in probes[fb]:
                q = np.zeros(model.num_bodies)
                q[fingers[fa]] = qa
                if fb >= 0:
                    q[fingers[fb]] = qb
                pos, rot = _np_fk_pose(model, q)
                sp = pos[sb] + np.einsum(
                    "bij,bj->bi", rot[sb], model.sphere_pos
                )
                d = np.linalg.norm(
                    sp[ia][:, None, :] - sp[ib][None, :, :], axis=-1
                )
                best = np.minimum(best, d - (r[ia][:, None] + r[ib][None, :]))
        for ai, bi in zip(*np.nonzero(best < margin)):
            pairs.append((int(ia[ai]), int(ib[bi])))
    return np.asarray(sorted(pairs), dtype=np.int64).reshape(-1, 2)

_CORNER_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    dtype=np.float32,
)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


class HandPhysics:
    """Static model arrays (on `device`: the card unless the caller passes
    "cpu") plus the batched step functions. Every state argument has a
    leading num_envs dim."""

    def __init__(self, model: HandModel | None = None,
                 params: SimParams | None = None, device="cuda"):
        self.model = model or build_hand_model()
        self.params = params or SimParams()
        p = self.params
        if p.has_box2 and not p.has_box:
            raise ValueError("SimParams.has_box2 requires has_box")
        self.device = resolve_device(device)
        m = self.model
        B = m.num_bodies
        anc = np.zeros((B, B), dtype=np.float32)
        for b in range(B):
            j = b
            while j >= 0:
                anc[j, b] = 1.0
                j = int(m.parent[j])
        self.anc_np = anc
        self.parent = [int(x) for x in m.parent]
        self.is_prismatic = [bool(x) for x in (m.joint_type == PRISMATIC)]
        self.has_post = [not np.allclose(m.post_quat[i], [0, 0, 0, 1]) for i in range(B)]
        f32 = lambda x: np.asarray(x, dtype=np.float32)
        # numpy copies (float32) feed the kernels' model buffer
        self.np = dict(
            axis=f32(m.axis), attach_pos=f32(m.attach_pos),
            attach_quat=f32(m.attach_quat), post_quat=f32(m.post_quat),
            mass=f32(m.mass), com=f32(m.com), inertia=f32(m.inertia),
            lower=f32(m.lower_limit), upper=f32(m.upper_limit),
            kp=f32(m.stiffness), kd=f32(m.damping), armature=f32(m.armature),
            sphere_pos=f32(m.sphere_pos), sphere_radius=f32(m.sphere_radius),
            sphere_meff=f32(compute_sphere_apparent_mass(m)),
            site_pos=f32(m.site_pos), site_quat=f32(m.site_quat),
        )
        sc = (compute_self_collision_pairs(m) if p.self_collision
              else np.zeros((0, 2), dtype=np.int64))
        meff = self.np["sphere_meff"]
        rad = self.np["sphere_radius"]
        self.sc_i, self.sc_j = sc[:, 0], sc[:, 1]
        self.np["sc_rsum"] = f32(rad[self.sc_i] + rad[self.sc_j])
        self.np["sc_meff"] = (
            f32(1.0 / (1.0 / meff[self.sc_i] + 1.0 / meff[self.sc_j]))
            if len(sc) else f32(np.zeros(0))
        )
        self.sphere_body = np.asarray(m.sphere_body, dtype=np.int64)
        self.site_body = np.asarray(m.site_body, dtype=np.int64)
        t = lambda x: torch.as_tensor(x, device=self.device)
        self.t = {k: t(v) for k, v in self.np.items()}
        self.t["anc"] = t(anc)
        for k in ("sphere_body", "site_body"):
            self.t[k] = t(getattr(self, k))
        self.t["sc_i"], self.t["sc_j"] = t(self.sc_i), t(self.sc_j)
        if p.has_box:
            self.box_inertia = p.box_mass * p.box_size**2 / 6.0
        if p.has_box2:
            self.box2_inertia = p.box2_mass * p.box2_size**2 / 6.0
        self.substep_dt = p.dt / p.substeps

    # ------------------------------------------------------------------
    def fk(self, q, qd, spawn_pos) -> KinematicsOut:
        """FK with velocity propagation. q, qd: (N, 26); spawn_pos: (N, 3)."""
        T = self.t
        n = q.shape[0]
        ident = torch.zeros(n, 4, dtype=q.dtype, device=q.device)
        ident[:, 3] = 1.0
        zero3 = torch.zeros(n, 3, dtype=q.dtype, device=q.device)
        pos, quat, lin, ang, axw, orig = [], [], [], [], [], []
        for i, par in enumerate(self.parent):
            if par < 0:
                pp, pq, pv, pw = spawn_pos, ident, zero3, zero3
            else:
                pp, pq, pv, pw = pos[par], quat[par], lin[par], ang[par]
            o = pp + qm.quat_rotate(pq, T["attach_pos"][i])
            jq = qm.quat_mul(pq, T["attach_quat"][i])
            a_w = qm.quat_rotate(jq, T["axis"][i])
            v_o = pv + _cross(pw, o - pp)
            if self.is_prismatic[i]:
                bp = o + a_w * q[:, i:i + 1]
                bq = jq
                bv = v_o + _cross(pw, bp - o) + a_w * qd[:, i:i + 1]
                bw = pw
            else:
                bp = o
                bq = qm.quat_mul(jq, qm.quat_from_axis_angle(T["axis"][i], q[:, i]))
                bv = v_o
                bw = pw + a_w * qd[:, i:i + 1]
            if self.has_post[i]:
                bq = qm.quat_mul(bq, T["post_quat"][i])
            pos.append(bp), quat.append(bq), lin.append(bv), ang.append(bw)
            axw.append(a_w), orig.append(o)
        body_pos = torch.stack(pos, 1)
        body_quat = torch.stack(quat, 1)
        sb = T["site_body"]
        return KinematicsOut(
            body_pos=body_pos, body_quat=body_quat,
            body_linvel=torch.stack(lin, 1), body_angvel=torch.stack(ang, 1),
            dof_axis_w=torch.stack(axw, 1), dof_origin_w=torch.stack(orig, 1),
            site_pos=body_pos[:, sb] + qm.quat_rotate(body_quat[:, sb], T["site_pos"]),
            site_quat=qm.quat_mul(body_quat[:, sb], T["site_quat"]),
        )

    def min_site_z(self, q, spawn_pos, site_ids) -> torch.Tensor:
        """Lowest world z over `site_ids` at pose q with zero velocity (the
        plain version of the kernels' spawn-projection FK)."""
        kin = self.fk(q, torch.zeros_like(q), spawn_pos)
        return kin.site_pos[:, list(site_ids), 2].amin(dim=1)

    def _motion_subspace(self, kin: KinematicsOut) -> torch.Tensor:
        a, o = kin.dof_axis_w, kin.dof_origin_w
        prism = torch.tensor(self.is_prismatic, device=a.device)[:, None]
        s_ang = torch.where(prism, torch.zeros_like(a), a)
        s_lin = torch.where(prism, a, _cross(o, a))
        return torch.cat([s_ang, s_lin], dim=-1)                  # (N, B, 6)

    def _spatial_inertia_o(self, kin: KinematicsOut) -> torch.Tensor:
        """Per-body spatial inertia (N, B, 6, 6) about the world origin."""
        T = self.t
        R = qm.quat_to_rotmat(kin.body_quat)                       # (N,B,3,3)
        com_w = kin.body_pos + torch.einsum("nbij,bj->nbi", R, T["com"])
        i_c = torch.einsum("nbij,bjk,nblk->nbil", R, T["inertia"], R)
        x, y, z = com_w.unbind(-1)
        zero = torch.zeros_like(x)
        cx = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).reshape(
            com_w.shape + (3,))
        mass = T["mass"][:, None, None]
        eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
        return torch.cat([
            torch.cat([i_c - mass * (cx @ cx), mass * cx], -1),
            torch.cat([-mass * cx, mass * eye], -1),
        ], -2)

    def mass_matrix(self, kin: KinematicsOut, S: torch.Tensor,
                    i_o: torch.Tensor | None = None) -> torch.Tensor:
        """Composite-rigid-body mass matrix (N, 26, 26), world coordinates.
        `i_o`: the per-body spatial inertias, when the caller (the Coriolis
        bias) built them already."""
        if i_o is None:
            i_o = self._spatial_inertia_o(kin)
        ic = list(i_o.unbind(1))
        for i in reversed(range(len(ic))):
            if self.parent[i] >= 0:
                ic[self.parent[i]] = ic[self.parent[i]] + ic[i]
        f = torch.einsum("nbij,nbj->nbi", torch.stack(ic, 1), S)
        raw = torch.einsum("nbi,nci->nbc", S, f)
        am = raw * self.t["anc"]
        return am + am.transpose(1, 2) - torch.diag_embed(torch.diagonal(raw, dim1=1, dim2=2))

    # ------------------------------------------------------------------
    def _penalty_force(self, depth, normal, rel_vel, mu, m_eff, m_t=None):
        """Compliant contact force on the first body; depth > 0 = contact.
        Spring-damper bounded by the one-substep stopping impulse."""
        p = self.params
        inv_h = 1.0 / self.substep_dt
        if m_t is None:
            m_t = m_eff
        active = (depth > 0.0).to(normal.dtype)
        vn = (rel_vel * normal).sum(-1)
        fn_spring = p.contact_stiffness * depth - p.contact_damping * vn
        corr = torch.clamp((p.contact_beta * inv_h) * depth,
                           max=p.max_depenetration_velocity)
        fn_impulse = m_eff * inv_h * (-vn + corr)
        fn_mag = torch.clamp(torch.minimum(fn_spring, fn_impulse), min=0.0) * active
        vt = rel_vel - vn[..., None] * normal
        vt_norm = _norm(vt)
        ft_mag = torch.minimum(
            torch.minimum(p.friction_stiffness * vt_norm, mu * fn_mag),
            m_t * inv_h * vt_norm,
        )
        ft = -vt / (vt_norm[..., None] + 1e-6) * ft_mag[..., None]
        return fn_mag[..., None] * normal + ft

    def _sphere_box(self, sp, sv, box, half, box_mass, box_inertia, mu, g_kick):
        """Spheres (N,S,3) vs one free cube, `box` = (pos, quat, linvel,
        angvel). Returns (force on spheres, force on box (N,3), torque on box
        (N,3))."""
        box_pos, box_quat, box_linvel, box_angvel = box
        r = self.t["sphere_radius"]
        Rb = qm.quat_to_rotmat(box_quat)                           # (N,3,3)
        local = torch.einsum("nsi,nij->nsj", sp - box_pos[:, None], Rb)
        closest = local.clamp(-half, half)
        d = local - closest
        dist = _norm(d)
        outside = dist > 1e-9
        n_out = d / (dist[..., None] + 1e-9)
        face_gap = half - local.abs()
        min_ax = face_gap.argmin(-1, keepdim=True)
        sign = torch.sign(local.gather(-1, min_ax))[..., 0]
        n_in = torch.nn.functional.one_hot(min_ax[..., 0], 3).to(sp.dtype) * torch.where(
            sign == 0.0, torch.ones_like(sign), sign)[..., None]
        depth_b = torch.where(outside, r - dist, r + face_gap.gather(-1, min_ax)[..., 0])
        n_world = torch.einsum("nsj,nij->nsi", torch.where(outside[..., None], n_out, n_in), Rb)
        surf = torch.where(outside[..., None], closest, local)
        r_c = torch.einsum("nsj,nij->nsi", surf, Rb)
        rel = sv - (box_linvel[:, None] + _cross(box_angvel[:, None], r_c))
        rel_pred = rel - g_kick
        share = torch.clamp((depth_b > 0.0).to(sp.dtype).sum(-1, keepdim=True), min=1.0)
        inv_bm = (1.0 / box_mass)[:, None]
        inv_bi = (1.0 / box_inertia)[:, None]
        share_bm = share * inv_bm
        ang_n = (_cross(r_c, n_world) ** 2).sum(-1) * inv_bi
        m_red_n = 1.0 / (1.0 / self.t["sphere_meff"] + share_bm + ang_n)
        vn_p = (rel_pred * n_world).sum(-1)
        vt_p = rel_pred - vn_p[..., None] * n_world
        t_hat = vt_p / (_norm(vt_p)[..., None] + 1e-9)
        ang_t = (_cross(r_c, t_hat) ** 2).sum(-1) * inv_bi
        m_red_t = 1.0 / (1.0 / self.t["sphere_meff"] + share_bm + ang_t)
        f_box = self._penalty_force(depth_b, n_world, rel_pred, mu, m_red_n, m_red_t)
        react = -f_box
        return f_box, react.sum(1), _cross(r_c, react).sum(1)

    def _box_ground(self, box, half, box_mass, box_inertia, mu, g_kick):
        """One free cube's corners vs the ground plane. Returns (force on
        box (N,3), torque on box (N,3))."""
        box_pos, box_quat, box_linvel, box_angvel = box
        Rb = qm.quat_to_rotmat(box_quat)
        corners_l = torch.as_tensor(_CORNER_SIGNS, device=Rb.device) * half
        r_c8 = torch.einsum("cj,nij->nci", corners_l, Rb)
        corners_w = box_pos[:, None] + r_c8
        vc = box_linvel[:, None] + _cross(box_angvel[:, None], corners_w - box_pos[:, None])
        n_up = torch.zeros_like(corners_w)
        n_up[..., 2] = 1.0
        r_c8 = corners_w - box_pos[:, None]
        ang8 = (_cross(r_c8, n_up) ** 2).sum(-1) * (1.0 / box_inertia)[:, None]
        m_corner = 1.0 / (4.0 * (1.0 / box_mass)[:, None] + ang8)
        f_c = self._penalty_force(-corners_w[..., 2], n_up, vc + g_kick, mu, m_corner)
        return f_c.sum(1), _cross(r_c8, f_c).sum(1)

    def _corners_vs_box(self, a, half_a, mass_a, inertia_a, b, half_b, mass_b, inertia_b,
                        mu):
        """Corners of free cube A vs free cube B (vertex narrowphase): a
        corner of A inside B is pushed out along B's nearest face normal.
        `a`, `b` = (pos, quat, linvel, angvel). Returns (force on A, torque
        on A, force on B, torque on B), each (N,3)."""
        pos_a, quat_a, lin_a, ang_a = a
        pos_b, quat_b, lin_b, ang_b = b
        RA, RB = qm.quat_to_rotmat(quat_a), qm.quat_to_rotmat(quat_b)
        corners_l = torch.as_tensor(_CORNER_SIGNS, device=RA.device) * half_a
        corners_w = pos_a[:, None] + torch.einsum("cj,nij->nci", corners_l, RA)  # (N,8,3)
        local = torch.einsum("nci,nij->ncj", corners_w - pos_b[:, None], RB)
        face_gap = half_b - local.abs()
        depth = face_gap.amin(-1)
        min_ax = face_gap.argmin(-1, keepdim=True)
        sign = torch.sign(local.gather(-1, min_ax))[..., 0]
        n_local = torch.nn.functional.one_hot(min_ax[..., 0], 3).to(local.dtype) * torch.where(
            sign == 0.0, torch.ones_like(sign), sign)[..., None]
        n_world = torch.einsum("ncj,nij->nci", n_local, RB)        # out of B, toward A
        r_a = corners_w - pos_a[:, None]
        r_b = corners_w - pos_b[:, None]
        rel = (lin_a[:, None] + _cross(ang_a[:, None], r_a)) - (
            lin_b[:, None] + _cross(ang_b[:, None], r_b))
        share = torch.clamp((depth > 0.0).to(local.dtype).sum(-1, keepdim=True), min=1.0)
        ang_na = (_cross(r_a, n_world) ** 2).sum(-1) / inertia_a[:, None]
        ang_nb = (_cross(r_b, n_world) ** 2).sum(-1) / inertia_b[:, None]
        m_red = 1.0 / (share / mass_a[:, None] + ang_na + share / mass_b[:, None] + ang_nb)
        f = self._penalty_force(depth, n_world, rel, mu, m_red)   # on A
        return (f.sum(1), _cross(r_a, f).sum(1), -f.sum(1), _cross(r_b, -f).sum(1))

    def _box_box(self, a, b, half_a, mass_a, inertia_a, half_b, mass_b, inertia_b, mu):
        """Symmetric cube-cube contact: the corners of each cube against the
        other. Returns (force_a, torque_a, force_b, torque_b)."""
        fa1, ta1, fb1, tb1 = self._corners_vs_box(a, half_a, mass_a, inertia_a,
                                                  b, half_b, mass_b, inertia_b, mu)
        fb2, tb2, fa2, ta2 = self._corners_vs_box(b, half_b, mass_b, inertia_b,
                                                  a, half_a, mass_a, inertia_a, mu)
        return fa1 + fa2, ta1 + ta2, fb1 + fb2, tb1 + tb2

    def _contacts(self, kin: KinematicsOut, st: PhysicsState, dr: DRSample):
        p, T = self.params, self.t
        sb = T["sphere_body"]
        bp, bq = kin.body_pos[:, sb], kin.body_quat[:, sb]
        sp = bp + qm.quat_rotate(bq, T["sphere_pos"])
        sv = kin.body_linvel[:, sb] + _cross(kin.body_angvel[:, sb], sp - bp)
        fr = dr.friction_scale[:, None]
        n_up = torch.zeros_like(sp)
        n_up[..., 2] = 1.0
        force = self._penalty_force(
            T["sphere_radius"] - sp[..., 2], n_up, sv,
            0.5 * (p.hand_friction + p.ground_friction) * fr, T["sphere_meff"])
        if len(self.sc_i):
            si, sj = T["sc_i"], T["sc_j"]
            d_sc = sp[:, si] - sp[:, sj]
            dist = _norm(d_sc)
            f_sc = self._penalty_force(
                T["sc_rsum"] - dist, d_sc / (dist[..., None] + 1e-9),
                sv[:, si] - sv[:, sj], p.hand_friction * fr, T["sc_meff"])
            force = force + torch.zeros_like(force).index_add_(1, si, f_sc) \
                - torch.zeros_like(force).index_add_(1, sj, f_sc)
        n = sp.shape[0]
        box_f = torch.zeros(n, 3, dtype=sp.dtype, device=sp.device)
        box_t = torch.zeros_like(box_f)
        box2_f = box2_t = None
        if p.has_box:
            g_kick = torch.tensor([0.0, 0.0, p.gravity * self.substep_dt],
                                  dtype=sp.dtype, device=sp.device)
            box = (st.box_pos, st.box_quat, st.box_linvel, st.box_angvel)
            bm = p.box_mass * dr.box_mass_scale
            bi = self.box_inertia * dr.box_mass_scale
            f_box, bf, bt = self._sphere_box(
                sp, sv, box, p.box_size / 2.0, bm, bi,
                0.5 * (p.hand_friction + p.box_friction) * fr, g_kick)
            force = force + f_box
            gf, gt = self._box_ground(
                box, p.box_size / 2.0, bm, bi,
                0.5 * (p.box_friction + p.ground_friction) * fr, g_kick)
            box_f = box_f + bf + gf
            box_t = box_t + bt + gt
        if p.has_box2:
            # the second cube: hand, ground and cube-cube contact; DR's mass
            # scale is shared with the first box (one scale per env)
            box2 = tuple(getattr(st, k) for k in BOX2_FIELDS)
            b2m = p.box2_mass * dr.box_mass_scale
            b2i = self.box2_inertia * dr.box_mass_scale
            f_b2, box2_f, box2_t = self._sphere_box(
                sp, sv, box2, p.box2_size / 2.0, b2m, b2i,
                0.5 * (p.hand_friction + p.box2_friction) * fr, g_kick)
            force = force + f_b2
            gf, gt = self._box_ground(
                box2, p.box2_size / 2.0, b2m, b2i,
                0.5 * (p.box2_friction + p.ground_friction) * fr, g_kick)
            box2_f, box2_t = box2_f + gf, box2_t + gt
            fa, ta, fb, tb = self._box_box(
                box, box2, p.box_size / 2.0, bm, bi, p.box2_size / 2.0, b2m, b2i,
                0.5 * (p.box_friction + p.box2_friction) * fr)
            box_f, box_t = box_f + fa, box_t + ta
            box2_f, box2_t = box2_f + fb, box2_t + tb
        return force, sp, box_f, box_t, box2_f, box2_t

    def _segment_sum(self, x):
        n = x.shape[0]
        out = torch.zeros(n, self.model.num_bodies, x.shape[-1], dtype=x.dtype, device=x.device)
        return out.index_add_(1, self.t["sphere_body"], x)

    def _substep(self, st: PhysicsState, targets, spawn, dr: DRSample, solve):
        """One substep; `solve(A, rhs)` is the batched SPD solve."""
        p, T = self.params, self.t
        h = self.substep_dt
        kin = self.fk(st.q, st.qd, spawn)
        S = self._motion_subspace(kin)
        force, pt, box_f, box_t, box2_f, box2_t = self._contacts(kin, st, dr)
        body_w = torch.cat([self._segment_sum(_cross(pt, force)),
                            self._segment_sum(force)], -1)         # (N,B,6)
        R = qm.quat_to_rotmat(kin.body_quat)
        com_w = kin.body_pos + torch.einsum("nbij,bj->nbi", R, T["com"])
        f_g = torch.zeros_like(com_w)
        f_g[..., 2] = T["mass"] * p.gravity
        body_w = body_w + torch.cat([_cross(com_w, f_g), f_g], -1)
        subtree_w = torch.einsum("bc,nck->nbk", T["anc"], body_w)
        Q = (S * subtree_w).sum(-1)
        i_o = None
        if p.coriolis:
            # RNEA velocity-product bias in world-origin Plücker coordinates
            # (engine.py:887-912): per-body p_bias = v x* (I_o v) with
            # v = (omega, v at the origin); C(q, qd) qd = S^T (subtree sums
            # of p_bias) enters the right-hand side with a minus sign
            i_o = self._spatial_inertia_o(kin)
            omega = kin.body_angvel
            v_o = kin.body_linvel - _cross(omega, kin.body_pos)
            hv = torch.einsum("nbij,nbj->nbi", i_o, torch.cat([omega, v_o], -1))
            p_bias = torch.cat([_cross(omega, hv[..., :3]) + _cross(v_o, hv[..., 3:]),
                                _cross(omega, hv[..., 3:])], -1)
            Q = Q - (S * torch.einsum("bc,nck->nbk", T["anc"], p_bias)).sum(-1)
        kp = T["kp"] * dr.kp_scale[:, None]
        kd = T["kd"] * dr.kd_scale[:, None]
        M = self.mass_matrix(kin, S, i_o=i_o) + torch.diag(T["armature"])
        A = M + torch.diag_embed(h * kd + h * h * kp)
        rhs = (M @ st.qd[..., None])[..., 0] + h * (kp * (targets - st.q) + Q)
        qd_new = solve(A.contiguous(), rhs.contiguous())
        q_new = st.q + h * qd_new
        low_hit, high_hit = q_new < T["lower"], q_new > T["upper"]
        q_new = torch.minimum(torch.maximum(q_new, T["lower"]), T["upper"])
        zero = torch.zeros_like(qd_new)
        qd_new = torch.where(low_hit & (qd_new < 0), zero, qd_new)
        qd_new = torch.where(high_hit & (qd_new > 0), zero, qd_new)
        new = dataclasses.replace(st, q=q_new, qd=qd_new)
        if p.has_box:
            new.box_pos, new.box_quat, new.box_linvel, new.box_angvel = self._integrate_box(
                (st.box_pos, st.box_quat, st.box_linvel, st.box_angvel), box_f, box_t,
                p.box_mass * dr.box_mass_scale, self.box_inertia * dr.box_mass_scale)
        if p.has_box2:
            new.box2_pos, new.box2_quat, new.box2_linvel, new.box2_angvel = self._integrate_box(
                tuple(getattr(st, k) for k in BOX2_FIELDS), box2_f, box2_t,
                p.box2_mass * dr.box_mass_scale, self.box2_inertia * dr.box_mass_scale)
        return new, StepInfo(self._segment_sum(force), box_f, box2_f)

    def _integrate_box(self, box, f, t, mass, inertia):
        """Semi-implicit Euler of one free cube (isotropic inertia) with
        PhysX-style velocity caps (10 m/s, 64 rad/s)."""
        pos, quat, lin0, ang0 = box
        h = self.substep_dt
        gvec = torch.tensor([0.0, 0.0, self.params.gravity], dtype=f.dtype, device=f.device)
        lin = lin0 + h * (f * (1.0 / mass[:, None]) + gvec)
        ang = ang0 + h * (1.0 / inertia[:, None]) * t
        lin = lin * torch.clamp(10.0 / (_norm(lin)[:, None] + 1e-9), max=1.0)
        ang = ang * torch.clamp(64.0 / (_norm(ang)[:, None] + 1e-9), max=1.0)
        return pos + h * lin, qm.quat_integrate(quat, ang, h), lin, ang

    def _op_control_step(self, n_physics_steps: int, solve):
        """fn(state, targets, spawn, dr) -> (state, StepInfo of the last
        substep, KinematicsOut of the final state): `n_physics_steps x
        substeps` substeps of this engine's ops with `solve`, then the final
        FK."""
        def fn(state: PhysicsState, targets, spawn, dr: DRSample):
            info = None
            for _ in range(n_physics_steps * self.params.substeps):
                state, info = self._substep(state, targets, spawn, dr, solve)
            return state, info, self.fk(state.q, state.qd, spawn)

        return fn

    def plain_control_step(self, n_physics_steps: int):
        """The plain control step: this engine's ops with the plain SPD solve
        (`linalg.spd_solve_plain`). K2's reference, and with
        `SimParams.coriolis` the reference of the Coriolis step."""
        return self._op_control_step(n_physics_steps, linalg.spd_solve_plain)

    def make_control_step(self, n_physics_steps: int):
        """The plain control step (the reference has no kernel)."""
        return self.plain_control_step(n_physics_steps)
