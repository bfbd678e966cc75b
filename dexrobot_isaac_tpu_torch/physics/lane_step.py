"""K2: the lane-physics control step and `min_site_z`, CUDA kernels + wrappers.

The port of `dexrobot_isaac_tpu/physics/pallas_step.py` (`build_lane_sim`,
`build_control_step`). The kernels are `csrc/control_step.cu` over the
shared per-env physics of `csrc/lane_physics.cuh`, built twice: for scenes
with one box (`control_step`) and with the second box (`control_step_box2`,
`SimParams.has_box2`); the engine's scene picks the build. This module
builds the model buffer they read (`LaneModel`, in the layout the compiled
library reports) and wraps the launches:

- `build_control_step(engine, n_physics_steps)` -> fn(state, targets, spawn,
  dr) -> (state, StepInfo, KinematicsOut): `n_physics_steps x substeps`
  substeps, then the final FK and site poses.
- `min_site_z(engine, dof_pos, spawn, site_ids)`: lowest world z over the
  sites at a zero-velocity pose (the spawn-validity projection).

On a CPU tensor each wrapper runs the plain version (`HandPhysics` in
physics/engine.py); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics, StepInfo
from dexrobot_isaac_tpu_torch.physics.types import (
    DRSample,
    KinematicsOut,
    PhysicsState,
    box_rows,
    from_box_rows,
)
from dexrobot_isaac_tpu_torch.utils import kernel_build as kb


def struct_dtype(layout_fn) -> np.dtype:
    """The numpy dtype of a kernel's config struct, read from the compiled
    library's `<struct>_layout` export (LP_STRUCT_LAYOUT in
    csrc/lane_physics.cuh): field names, byte offsets, element counts,
    float-ness and the struct size, all from the struct's X-macro field list,
    which is the layout's only definition."""
    cap = 256
    offs, counts, is_f = ((ctypes.c_int * cap)() for _ in range(3))
    size, names = ctypes.c_int(), ctypes.c_char_p()
    ip = ctypes.POINTER(ctypes.c_int)
    layout_fn.argtypes = [ctypes.c_int, ip, ip, ip, ip, ctypes.POINTER(ctypes.c_char_p)]
    k = layout_fn(cap, offs, counts, is_f, ctypes.byref(size), ctypes.byref(names))
    if k > cap:
        raise RuntimeError(f"struct of {k} fields: raise the cap of {cap}")
    kind = lambda j: "f4" if is_f[j] else "i4"
    return np.dtype({"names": names.value.decode().rstrip(",").split(","),
                     "formats": [(kind(j), (counts[j],)) if counts[j] else kind(j)
                                 for j in range(k)],
                     "offsets": list(offs)[:k], "itemsize": size.value})


def lane_model_array(engine: HandPhysics, n_physics_steps: int, lib: ctypes.CDLL) -> np.ndarray:
    """The LaneModel struct (one numpy record) for this engine, in the layout
    that `lib` (either kernel library) was compiled with."""
    r = np.zeros((), dtype=struct_dtype(lib.lane_model_layout))
    m, p, a = engine.model, engine.params, engine.np
    nb = m.num_bodies
    ns, n_sc, nsite = len(engine.sphere_body), len(engine.sc_i), len(engine.site_body)
    maxb = r["parent"].size
    maxd = r["anc"].size // maxb
    if nb > maxb or ns > r["sb"].size or n_sc > r["sc_i"].size or nsite > r["site_b"].size:
        raise ValueError("model exceeds the lane kernel's static sizes")
    h = float(engine.substep_dt)
    r["nb"], r["ns"], r["n_sc"], r["nsite"] = nb, ns, n_sc, nsite
    r["total_substeps"] = int(n_physics_steps * p.substeps)
    r["has_box"] = int(p.has_box)
    r["h"], r["inv_h"], r["gz"] = h, 1.0 / h, p.gravity
    r["k_contact"], r["d_contact"] = p.contact_stiffness, p.contact_damping
    r["k_friction"], r["beta_inv_h"] = p.friction_stiffness, p.contact_beta * (1.0 / h)
    r["max_depen"] = p.max_depenetration_velocity
    r["mu_hg"] = 0.5 * (p.hand_friction + p.ground_friction)
    r["mu_hb"] = 0.5 * (p.hand_friction + p.box_friction)
    r["mu_bg"] = 0.5 * (p.box_friction + p.ground_friction)
    r["mu_hh"] = p.hand_friction
    r["box_mass"] = p.box_mass
    r["box_inertia"] = p.box_mass * p.box_size ** 2 / 6.0 if p.has_box else 1.0
    r["half"] = p.box_size / 2.0
    r["has_box2"] = int(p.has_box2)
    r["mu_hb2"] = 0.5 * (p.hand_friction + p.box2_friction)
    r["mu_b2g"] = 0.5 * (p.box2_friction + p.ground_friction)
    r["mu_bb"] = 0.5 * (p.box_friction + p.box2_friction)
    r["box2_mass"] = p.box2_mass
    r["box2_inertia"] = p.box2_mass * p.box2_size ** 2 / 6.0
    r["half2"] = p.box2_size / 2.0
    parent = [int(x) for x in m.parent]
    r["parent"][:nb] = parent
    r["is_prism"][:nb] = engine.is_prismatic
    r["has_post"][:nb] = engine.has_post
    msub = [float(x) for x in a["mass"]]
    for i in reversed(range(nb)):
        if parent[i] >= 0:
            msub[parent[i]] += msub[i]
    anc = r["anc"].reshape(maxb, maxd)
    for b in range(nb):
        chain, j = [], b
        while j >= 0:
            chain.append(j)
            j = parent[j]
        if len(chain) > maxd:
            raise ValueError("tree deeper than the lane kernel's static depth")
        r["depth"][b] = len(chain)
        anc[b, :len(chain)] = sorted(chain)
    max_m, lanes, box2 = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.lane_caps(ctypes.byref(max_m), ctypes.byref(lanes), ctypes.byref(box2))
    if int(r["depth"][:nb].sum()) > max_m.value:
        raise ValueError("mass matrix larger than the lane kernel's static size")
    if bool(box2.value) != p.has_box2:
        raise ValueError(f"a kernel library built {'with' if box2.value else 'without'} the "
                         f"second box for a scene {'with' if p.has_box2 else 'without'} it")
    _tree_tables(r, parent, engine.sphere_body, engine.sc_i, engine.sc_j, lanes.value,
                 p.has_box2)
    for key, src in (("axis", "axis"), ("apos", "attach_pos"), ("aquat", "attach_quat"),
                     ("post", "post_quat"), ("mass", "mass"), ("com", "com"),
                     ("inertia", "inertia"), ("lower", "lower"), ("upper", "upper"),
                     ("kp", "kp"), ("kd", "kd"), ("arm", "armature")):
        flat = a[src].reshape(-1)
        r[key][:flat.size] = flat
    r["subtree_mass"][:nb] = msub
    r["sb"][:ns] = engine.sphere_body
    r["spos"][:3 * ns] = a["sphere_pos"].reshape(-1)
    r["srad"][:ns] = a["sphere_radius"]
    r["smeff"][:ns] = a["sphere_meff"]
    r["sc_i"][:n_sc], r["sc_j"][:n_sc] = engine.sc_i, engine.sc_j
    r["sc_rsum"][:n_sc], r["sc_meff"][:n_sc] = a["sc_rsum"], a["sc_meff"]
    r["site_b"][:nsite] = engine.site_body
    r["site_pos"][:3 * nsite] = a["site_pos"].reshape(-1)
    r["site_quat"][:4 * nsite] = a["site_quat"].reshape(-1)
    return r


def _tree_tables(r: np.ndarray, parent, sphere_body, sc_i, sc_j, n_lanes: int,
                 has_box2: bool = False) -> None:
    """The warp design's tables of the tree (lane_physics.cuh): levels,
    mass-matrix row offsets, the bodies of each lane's slots, the LTL
    steps' update targets, each body's descendants (ascending), children
    (descending) and contacts (its spheres, then its pairs, then with the
    second box its spheres against it, in index order)."""
    nb, ns = len(parent), len(sphere_body)
    depth = r["depth"][:nb]
    r["n_levels"] = int(depth.max())
    moff = np.concatenate([[0], np.cumsum(depth)[:-1]]).astype(int)
    r["moff"][:nb] = moff
    # lanes: each tree level in one slot where it fits (a level phase then
    # runs one slot), levels in order; bodies in index order within a slot
    n_slots = r["slot_body"].size // n_lanes
    slots, k = [[] for _ in range(n_slots)], 0
    for lev in range(1, int(depth.max()) + 1):
        bodies = [b for b in range(nb) if depth[b] == lev]
        while k < n_slots - 1 and len(slots[k]) + len(bodies) > n_lanes:
            k += 1
        room = n_lanes - len(slots[k])
        slots[k] += bodies[:room]
        for b in bodies[room:]:  # a level larger than a slot spills over
            k2 = next(j for j in range(n_slots) if len(slots[j]) < n_lanes)
            slots[k2].append(b)
    r["slot_body"][:] = -1
    for k, bodies in enumerate(slots):
        r["slot_body"][k * n_lanes:k * n_lanes + len(bodies)] = sorted(bodies)
    # LTL step kk: per (ii, jj <= ii < depth - 1) the M index of (anc[kk][ii], jj)
    anc = r["anc"].reshape(r["parent"].size, -1)
    n_tri = r["ltl"].size // r["parent"].size
    ltl = r["ltl"].reshape(-1, n_tri)
    for kk in range(nb):
        e = 0
        for ii in range(int(depth[kk]) - 1):
            for jj in range(ii + 1):
                ltl[kk, e] = (moff[anc[kk, ii]] + jj) | (ii << 16) | (jj << 24)
                e += 1
    maxch = r["child"].size // r["parent"].size
    maxbc = r["bc"].size // r["parent"].size
    child, bc = r["child"].reshape(-1, maxch), r["bc"].reshape(-1, maxbc)
    n_desc = 0
    for b in range(nb):
        desc = [i for i in range(b + 1, nb) if b in _chain(parent, i)]
        r["desc_off"][b] = n_desc
        for i in desc:
            r["desc"][n_desc] = (moff[i] + depth[b] - 1) | (i << 16)
            n_desc += 1
        r["desc_off"][b + 1] = n_desc
        kids = [i for i in range(nb - 1, b, -1) if parent[i] == b]
        cons = [j | (j << 8) for j in range(ns) if sphere_body[j] == b]
        for p, (si, sj) in enumerate(zip(sc_i, sc_j)):
            if sphere_body[si] == b:
                cons.append((ns + p) | (int(si) << 8))
            if sphere_body[sj] == b:
                cons.append((ns + p) | (int(sj) << 8) | (1 << 16))
        if has_box2:
            cons += [(ns + len(sc_i) + j) | (j << 8) for j in range(ns) if sphere_body[j] == b]
        if len(kids) > maxch or len(cons) > maxbc:
            raise ValueError("tree or contacts exceed the lane kernel's static sizes")
        r["nchild"][b], r["nbc"][b] = len(kids), len(cons)
        child[b, :len(kids)] = kids
        bc[b, :len(cons)] = cons


def _chain(parent, i):
    out = []
    while i >= 0:
        out.append(i)
        i = parent[i]
    return out


# f32 operations of lane_physics.cuh, counted from its code: each add, mul,
# compare/select, divide and sqrt/rsqrt/exp/sin/cos counts one. Used for the
# kernels' roofline bound; the kernel does the same work for every env.
_QROT, _QMUL, _CROSS, _DOT, _MATVEC, _ROTMAT, _CF = 30, 28, 9, 5, 15, 24, 40


def fk_flops(r: np.ndarray) -> int:
    nb = int(r["nb"])
    n_prism, n_post = int(r["is_prism"][:nb].sum()), int(r["has_post"][:nb].sum())
    per_body = 2 * _QROT + _QMUL + 12 + _CROSS
    return (nb * per_body + n_prism * (18 + _CROSS) + (nb - n_prism) * (12 + _QMUL)
            + n_post * _QMUL)


def substep_flops(r: np.ndarray) -> int:
    nb, ns, n_sc = int(r["nb"]), int(r["ns"]), int(r["n_sc"])
    depth = r["depth"][:nb].astype(np.int64)
    n_mass = int((r["mass"][:nb] > 0).sum())
    f = fk_flops(r) + ns * (_QROT + 9 + _CROSS)               # FK, sphere pos/vel
    f += ns * (2 + _CF) + ns * (12 + _CROSS)                 # ground, accumulate
    geo = _MATVEC + 25
    sphere_box = ns * (geo + 2 * _MATVEC + 4 * _CROSS + 4 * _DOT + 40 + _CF)
    corners_ground = 8 * (_MATVEC + 3 * _CROSS + _DOT + 14 + _CF)
    if int(r["has_box"]):
        f += 4 + _ROTMAT + ns * geo                           # active-contact pass
        f += sphere_box + corners_ground
    if int(r["has_box2"]):
        f += 4 + _ROTMAT + ns * geo + sphere_box + corners_ground + ns * 3  # + hand sums
        corner_box = 2 * _MATVEC + 12                         # corner, local, gaps, depth
        f += 16 * corner_box + 4                              # flags pass, masses
        f += 16 * (corner_box + _MATVEC + 5 + 4 * _CROSS + 2 * _DOT + 9 + _CF + 2 * _CROSS)
        f += 2 * 3 * (ns + 8) + 4 * 16 * 3 + 4 * 3 + 80      # box sums, integration
    f += n_sc * (_DOT + 13 + _CF + 2 * (12 + _CROSS))       # finger pairs
    f += n_mass * (_ROTMAT + _MATVEC + 7 + _CROSS)           # gravity
    f += (nb - 1) * 6 + nb * (2 * _DOT + 1 + _CROSS)         # subtree sums, Q
    f += n_mass * 100 + (nb - 1) * 9 + nb * (21 + 2 * _CROSS)  # CRBA
    f += int(depth.sum()) * (2 * _DOT + 1 + 4) + nb * 9      # M entries, rhs
    f += int(depth.sum()) + int((depth * (depth - 1)).sum()) + nb  # LTL
    f += 4 * int(depth.sum()) + nb * 6 + (80 if int(r["has_box"]) else 0)  # solves, integrate
    return f


def control_step_flops(r: np.ndarray, n_sites: int | None = None) -> int:
    """Per env: total_substeps substeps + the final FK and `n_sites` site
    poses (lp_site; all the model's sites by default)."""
    n_sites = int(r["nsite"]) if n_sites is None else n_sites
    return int(r["total_substeps"]) * substep_flops(r) + fk_flops(r) + n_sites * (
        _QROT + 3 + _QMUL)


def min_site_z_flops(r: np.ndarray, n_sites: int) -> int:
    """Per pose: lp_min_site_z over `n_sites` sites (FK, then each site's
    rotated offset, add and min)."""
    return fk_flops(r) + n_sites * (_QROT + 2)


def record_buffer(record: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy record's bytes as a uint8 tensor on `device`."""
    return torch.frombuffer(bytearray(record.tobytes()), dtype=torch.uint8).to(device)


def model_buffer(engine: HandPhysics, n_physics_steps: int, lib: ctypes.CDLL,
                 device: torch.device) -> torch.Tensor:
    """The LaneModel as a byte buffer on the engine's device, built once per
    engine. Raises unless `device`, the operands' device, is the engine's:
    the kernel reads the buffer through a raw pointer."""
    if device != engine.device:
        raise ValueError(f"kernel operands on {device}, but the engine and its model "
                         f"buffer on {engine.device}")
    cache: Dict = engine.__dict__.setdefault("_lane_buffers", {})
    if n_physics_steps not in cache:
        cache[n_physics_steps] = record_buffer(
            lane_model_array(engine, n_physics_steps, lib), engine.device)
    return cache[n_physics_steps]


def shared_layout(lib: ctypes.CDLL):
    """Shared memory per env of K2 and of min_site_z (bytes), envs per
    block, and the design's budget per env (bytes) (`control_step_shared` in
    control_step.cu)."""
    vals = [ctypes.c_int() for _ in range(4)]
    lib.control_step_shared(*(ctypes.byref(v) for v in vals))
    return tuple(v.value for v in vals)


def build_name(engine: HandPhysics) -> str:
    """The K2 library that runs this engine's scene."""
    return "control_step_box2" if engine.params.has_box2 else "control_step"


def _lib(engine: HandPhysics) -> ctypes.CDLL:
    lib = kb.load(build_name(engine))
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.control_step_launch.argtypes = [P] * 13 + [I, P]
        lib.min_site_z_launch.argtypes = [P, P, P, I, P, I, P]
        lib._typed = True
    return lib


def check_rows(x: torch.Tensor, rows: int, n: int, dtype=torch.float32) -> int:
    """Kernel operand check: a contiguous (rows, n) CUDA tensor of `dtype`."""
    if x.device.type != "cuda" or x.dtype != dtype or tuple(x.shape) != (rows, n) \
            or not x.is_contiguous():
        raise ValueError(f"kernel operand must be a contiguous ({rows}, {n}) {dtype} CUDA "
                         f"tensor, got {tuple(x.shape)} {x.dtype} on {x.device}")
    return x.data_ptr()


def require_cuda(x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")


def control_step_rows(engine, n_physics_steps, q, qd, tgt, spawn, box, dr):
    """The raw K2 launch on SoA rows: q, qd, tgt (26, N), spawn (3, N), box
    (13, N; 26 with the second box), dr (4, N) -> (q, qd, box, cf (78, N),
    bf (3, N; 6 with the second box), kin (564, N))."""
    name = build_name(engine)
    lib = _lib(engine)
    nb, n = engine.model.num_bodies, q.shape[1]
    nsite = len(engine.site_body)
    nbox = 26 if engine.params.has_box2 else 13
    buf = model_buffer(engine, n_physics_steps, lib, q.device)
    ins = [check_rows(x, r, n) for x, r in
           ((q, nb), (qd, nb), (tgt, nb), (spawn, 3), (box, nbox), (dr, 4))]
    e = lambda r: torch.empty(r, n, dtype=torch.float32, device=q.device)
    outs = [e(nb), e(nb), e(nbox), e(nb * 3), e(nbox // 13 * 3), e(nb * 19 + nsite * 7)]
    kb.check(lib.control_step_launch(buf.data_ptr(), *ins, *(o.data_ptr() for o in outs),
                                     n, kb.stream_ptr(q.device)), name)
    kb.LAUNCHES[name] += 1
    return outs


def unpack_kin(kin_rows: torch.Tensor, nb: int, nsite: int) -> KinematicsOut:
    """(nb*19 + nsite*7, N) kinematics rows -> KinematicsOut."""
    kt = kin_rows.t()
    n = kt.shape[0]
    parts, o = [], 0
    for d in (3, 4, 3, 3, 3, 3):
        parts.append(kt[:, o:o + nb * d].reshape(n, nb, d))
        o += nb * d
    return KinematicsOut(*parts, site_pos=kt[:, o:o + nsite * 3].reshape(n, nsite, 3),
                         site_quat=kt[:, o + nsite * 3:].reshape(n, nsite, 4))


def build_control_step(engine: HandPhysics, n_physics_steps: int):
    """fn(state, targets, spawn, dr) -> (state, StepInfo, KinematicsOut):
    the kernel on CUDA tensors, `engine.plain_control_step` on CPU ones."""
    plain = engine.plain_control_step(n_physics_steps)
    nb, nsite = engine.model.num_bodies, len(engine.site_body)
    has_box2 = engine.params.has_box2

    def fn(state: PhysicsState, targets, spawn, dr: DRSample):
        if state.q.device.type == "cpu":
            return plain(state, targets, spawn, dr)
        require_cuda(state.q)
        T = lambda x: x.float().t().contiguous()
        q, qd, bo, cf, bf, kin = control_step_rows(
            engine, n_physics_steps, T(state.q), T(state.qd), T(targets), T(spawn),
            T(box_rows(state, has_box2)), dr.rows().contiguous())
        n = q.shape[1]
        new = PhysicsState(q.t(), qd.t(), **from_box_rows(bo.t()))
        bf = bf.t()
        info = StepInfo(cf.t().reshape(n, nb, 3), bf[:, :3], bf[:, 3:6] if has_box2 else None)
        return new, info, unpack_kin(kin, nb, nsite)

    return fn


def min_site_z(engine: HandPhysics, dof_pos: torch.Tensor, spawn: torch.Tensor,
               site_ids: Sequence[int]) -> torch.Tensor:
    """(N, 26) poses -> (N,) lowest world z over `site_ids` (zero velocity);
    spawn is (3,) or (N, 3)."""
    n = dof_pos.shape[0]
    spawn = spawn.expand(n, 3)
    if dof_pos.device.type == "cpu":
        return engine.min_site_z(dof_pos, spawn, site_ids)
    require_cuda(dof_pos)
    lib = _lib(engine)
    buf = model_buffer(engine, 1, lib, dof_pos.device)
    q = dof_pos.float().t().contiguous()
    sp = spawn.float().t().contiguous()
    out = torch.empty(n, dtype=torch.float32, device=dof_pos.device)
    mask = sum(1 << int(s) for s in site_ids)
    kb.check(lib.min_site_z_launch(buf.data_ptr(), check_rows(q, engine.model.num_bodies, n),
                                   check_rows(sp, 3, n), mask, out.data_ptr(), n,
                                   kb.stream_ptr(dof_pos.device)), "min_site_z")
    kb.LAUNCHES["min_site_z"] += 1
    return out
