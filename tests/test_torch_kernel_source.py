"""The CUDA kernels' arithmetic, built for the host and held to the plain
versions (CPU).

`csrc/control_step.cu` and `csrc/fused_step.cu` also compile as plain C++
(their per-env code is __device__ only under nvcc), so g++ builds the same
per-env functions into host libraries with a loop over envs. The wrappers
never run these: on a CPU tensor they run the plain versions, on a CUDA
tensor the nvcc-built kernels. This checks the kernel source here, where no
card is: the struct layouts the wrappers fill, K2 and min_site_z against the
plain engine, and K1 against the TPU-recorded golden trajectory (obs atol
2e-4, reward/components atol 1e-3, done exact) and the plain fused step; and the warp design itself: every warp phase gives the
same bits whichever order its lanes run in (a phase that reads a value
another lane writes in the same phase does not), and each env's slot of
shared memory stays within the budget the design states. Every build of
`kernel_build.BUILDS` but K3's is built here with its defines: K2 with the
second box (held to the plain engine on a two-cube state, and on one with
finger spheres pressed into the second cube, which exercises the two-cube
build's second contact pass), and K1's
BaseTask, BoxStacking, BoxReorientation, InHandReorientation and BoxPushing
builds (held to the plain fused step, as the BlindGrasping build is on the
README recipe and on BlindGraspingClearance, and with K2 on the hand
loaded from the vendored MJCF file, whose collision spheres and finger pairs
come in another order); the BlindGrasping builds keep their slot sizes,
every shipped configuration fits its build's staging, and one that does not
is refused when the fused step is made.
"""

import ctypes
import logging
import os

import numpy as np
import pytest
import torch

from dexrobot_isaac_tpu_torch import train as cli
from dexrobot_isaac_tpu_torch.constants import NUM_BASE_DOFS
from dexrobot_isaac_tpu_torch.envs import fused_step as fsm
from dexrobot_isaac_tpu_torch.envs.fused_step import FusedUnsupported
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.ops import quat as qm
from dexrobot_isaac_tpu_torch.physics import lane_step as ls
from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics
from dexrobot_isaac_tpu_torch.physics.types import SimParams, box_rows
from dexrobot_isaac_tpu_torch.utils.config import load_config
from dexrobot_isaac_tpu_torch.utils.kernel_build import BUILDS, CSRC
from tests import golden_scenario as gs
from tests.proc import start, wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.as_tensor
GXX_TIMEOUT = 200  # seconds for the host builds, all at once
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """Every K1 and K2 build, compiled for the host by g++ (all at once)."""
    out = tmp_path_factory.mktemp("host_kernels")
    names = [b for b, (src, _) in BUILDS.items() if src in ("control_step", "fused_step")]
    procs = {b: start(["g++", "-x", "c++", "-O2", "-std=c++17", "-shared", "-fPIC",
                       *BUILDS[b][1], "-o", str(out / f"{b}.so"),
                       os.path.join(CSRC, BUILDS[b][0] + ".cu")]) for b in names}
    wait_all(list(procs.values()), GXX_TIMEOUT)
    assert all(p.returncode == 0 for p in procs.values())
    libs = {b: ctypes.CDLL(str(out / f"{b}.so")) for b in names}
    for b, lib in libs.items():
        if BUILDS[b][0] == "control_step":
            lib.control_step_host.argtypes = [P] * 13 + [I]
            lib.min_site_z_host.argtypes = [P, P, P, I, P, I]
        else:
            lib.fused_step_host.argtypes = [P] * 13 + [I]
        lib.lane_order_host.argtypes = [I]
    return libs


def _buf(record):
    return torch.frombuffer(bytearray(record.tobytes()), dtype=torch.uint8)


def _host_fused(lib, env, fused, rows_f, rows_i, act_T, rst_T, drn_T):
    c = env.comps
    model = _buf(ls.lane_model_array(c.engine, c.physics_steps_per_control, lib))
    cfg = _buf(fsm.fused_config_array(env, fused.layout, fused.comp_names, fused.rst_rows, lib))
    n = rows_f.shape[1]
    spw = env._spawn[:, None].expand(3, n).contiguous()
    e = lambda r, dt=torch.float32: torch.empty(r, n, dtype=dt)
    outs = [e(fused.layout.rows_c), e(fused.obs_dim), e(1), e(4, torch.int32),
            e(len(fused.comp_names))]
    lib.fused_step_host(model.data_ptr(), cfg.data_ptr(), rows_f.data_ptr(), rows_i.data_ptr(),
                        act_T.data_ptr(), rst_T.data_ptr(), drn_T.data_ptr(), spw.data_ptr(),
                        *(o.data_ptr() for o in outs), n)
    return outs


@pytest.fixture(scope="module")
def contact_state():
    """64 BlindGrasping envs (default physics) after 4 plain steps of random
    actions: hands, fingers and boxes in contact."""
    env = make_env(load_config(["task=BlindGrasping", "numEnvs=64"]), seed=3, device="cpu")
    fused = env.make_fused()
    fs, _ = fused.reset()
    g = torch.Generator().manual_seed(4)
    for _ in range(4):
        fs, *_ = fused.step_fn(fs, torch.rand(64, env.num_actions, generator=g) * 2 - 1)
    return env, fused, fs, g


@pytest.mark.parametrize("lib,fn", [
    ("control_step", "lane_model_layout"),
    ("fused_step", "lane_model_layout"),
    ("fused_step", "fused_config_layout"),
    ("fused_step_stacking", "lane_model_layout"),
    ("fused_step_stacking", "fused_config_layout"),
])
def test_struct_layouts_match_the_wrappers(host_libs, contact_state, lib, fn):
    """The dtype read from a library's layout export tiles the struct with
    4-byte fields and no gaps, K1 and K2 of one scene agree on LaneModel,
    and the wrapper fills every field it names (numpy raises on a missing
    one)."""
    dt = ls.struct_dtype(getattr(host_libs[lib], fn))
    fields = sorted(dt.fields.values(), key=lambda f: f[1])
    ends = [off + f.itemsize for f, off in fields]
    assert [off for _, off in fields] == [0] + ends[:-1] and ends[-1] == dt.itemsize
    assert all(f.base in (np.dtype("f4"), np.dtype("i4")) for f, _ in fields)
    env, fused, _, _ = contact_state
    if fn == "lane_model_layout":
        k2 = "control_step_box2" if lib == "fused_step_stacking" else "control_step"
        assert dt == ls.struct_dtype(host_libs[k2].lane_model_layout)
        if lib == "fused_step_stacking":
            with pytest.raises(ValueError, match="second box"):  # a one-box scene
                ls.lane_model_array(env.comps.engine, 4, host_libs[lib])
            return
        r = ls.lane_model_array(env.comps.engine, 4, host_libs[lib])
        assert int(r["total_substeps"]) == 4 * env.comps.engine.params.substeps
    else:
        r = fsm.fused_config_array(env, fused.layout, fused.comp_names, fused.rst_rows,
                                   host_libs[lib])
        assert int(r["obs_dim"]) == fused.obs_dim and int(r["n_comp"]) == len(fused.comp_names)
    assert r.dtype == dt


def test_lane_model_buffer_layout(host_libs):
    te = HandPhysics(params=SimParams(dt=0.01, substeps=2, has_box=True), device="cpu")
    r = ls.lane_model_array(te, 4, host_libs["control_step"])
    assert int(r["total_substeps"]) == 8 and int(r["nb"]) == 26
    parent = r["parent"][:26]
    anc = r["anc"].reshape(r["parent"].size, -1)
    for b in range(26):
        chain = anc[b, :r["depth"][b]]
        assert chain[-1] == b and all(parent[chain[k + 1]] == chain[k]
                                      for k in range(len(chain) - 1))
    assert np.isclose(r["subtree_mass"][0], te.np["mass"].sum())
    assert ls.control_step_flops(r) > 8 * ls.substep_flops(r) > 0


def test_lane_model_tree_tables(host_libs):
    """The warp design's tables: every body in exactly one lane slot, each
    level's bodies in one slot; each LTL step's update targets are the
    entries (anc[kk][ii], jj <= ii) of its proper ancestors' rows; each
    body's descendant list and children list cover its subtree."""
    te = HandPhysics(params=SimParams(dt=0.01, substeps=2, has_box=True), device="cpu")
    r = ls.lane_model_array(te, 1, host_libs["control_step"])
    nb, maxb = int(r["nb"]), r["parent"].size
    parent, depth = r["parent"][:nb], r["depth"][:nb]
    anc = r["anc"].reshape(maxb, -1)
    moff = r["moff"][:nb]
    slots = r["slot_body"].reshape(-1, r["slot_body"].size // 2)
    assert sorted(int(b) for b in slots.ravel() if b >= 0) == list(range(nb))
    assert int(r["n_levels"]) == int(depth.max()) == 10
    for lev in range(1, 11):
        assert len({k for k in range(2) for b in slots[k] if b >= 0 and depth[b] == lev}) == 1
    ltl = r["ltl"].reshape(maxb, -1)
    for kk in range(nb):
        want = [(int(moff[anc[kk, ii]]) + jj, ii, jj) for ii in range(depth[kk] - 1)
                for jj in range(ii + 1)]
        got = [(int(t) & 0xFFFF, (int(t) >> 16) & 255, int(t) >> 24)
               for t in ltl[kk, :len(want)]]
        assert got == want
    for b in range(nb):
        desc = [i for i in range(nb) if i != b and b in anc[i, :depth[i]]]
        lst = r["desc"][r["desc_off"][b]:r["desc_off"][b + 1]]
        assert [int(t) >> 16 for t in lst] == desc
        assert [int(t) & 0xFFFF for t in lst] == [int(moff[i]) + depth[b] - 1 for i in desc]
        kids = r["child"].reshape(maxb, -1)[b, :r["nchild"][b]]
        assert list(kids) == sorted((i for i in range(nb) if parent[i] == b), reverse=True)


def test_control_step_source_matches_plain(host_libs, contact_state):
    env, fused, fs, _ = contact_state
    c, n = env.comps, 64
    st = fused.unpack(fs)
    spawn = env._spawn.expand(n, 3)
    ref, info, kin = env._plain_control_step(st.physics, st.full_dof_targets, spawn, st.dr)
    model = _buf(ls.lane_model_array(c.engine, c.physics_steps_per_control,
                                     host_libs["control_step"]))
    Tt = lambda x: x.float().t().contiguous()
    ph = st.physics
    box = torch.cat([ph.box_pos, ph.box_quat, ph.box_linvel, ph.box_angvel], 1)
    ins = [Tt(ph.q), Tt(ph.qd), Tt(st.full_dof_targets), Tt(spawn), Tt(box), st.dr.rows()]
    outs = [torch.empty(r, n) for r in (26, 26, 13, 78, 3, 26 * 19 + 70)]
    host_libs["control_step"].control_step_host(
        model.data_ptr(), *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs), n)
    k = ls.unpack_kin(outs[5], 26, 10)
    ref_box = torch.cat([ref.box_pos, ref.box_quat, ref.box_linvel, ref.box_angvel], 1)
    for got, want in ((outs[0].t(), ref.q), (outs[1].t(), ref.qd), (outs[2].t(), ref_box),
                      (outs[3].t(), info.body_contact_force.reshape(n, -1)),
                      (outs[4].t(), info.box_contact_force), (k.body_pos, kin.body_pos),
                      (k.body_quat, kin.body_quat), (k.site_pos, kin.site_pos),
                      (k.body_linvel, kin.body_linvel)):
        assert float((got - want).abs().max() / want.abs().max().clamp_min(1e-6)) <= 1e-3
    assert bool((info.body_contact_force.abs().sum((1, 2)) > 0).all())


def test_min_site_z_source_matches_plain(host_libs, contact_state):
    env, fused, fs, _ = contact_state
    c, n = env.comps, 64
    q = fused.unpack(fs).physics.q
    tips = [int(s) for s in c.obs_cfg.fingertip_site_indices]
    model = _buf(ls.lane_model_array(c.engine, 1, host_libs["control_step"]))
    out = torch.empty(n)
    qT, sp = q.t().contiguous(), env._spawn[:, None].expand(3, n).contiguous()
    host_libs["control_step"].min_site_z_host(model.data_ptr(), qT.data_ptr(), sp.data_ptr(),
                                              sum(1 << s for s in tips), out.data_ptr(), n)
    want = c.engine.min_site_z(q, env._spawn.expand(n, 3), tips)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


def test_fused_step_source_replays_golden(host_libs):
    ops = {k: T(v) for k, v in np.load(os.path.join(
        REPO, "dexrobot_isaac_tpu_torch", "data", "golden_operands.npz")).items()}
    golden = dict(np.load(os.path.join(REPO, "tests", gs.GOLDEN)))
    env = make_env(load_config(list(gs.CONFIG)), seed=gs.SEED, device="cpu")
    fused = env.make_fused()
    fs, _ = fused.reset(samples=(fused.reset_from_rows(ops["init_rst"]), None))
    rf, ri = fs.rows_f.clone(), fs.rows_i.clone()
    got = {k: [] for k in ("obs", "rew", "done", "comp")}
    for t in range(gs.STEPS):
        _, obs, rew, msk, cmp = _host_fused(host_libs["fused_step"], env, fused, rf, ri,
                                            ops["actions"][t].t().contiguous(),
                                            ops["rst"][t].contiguous(), ops["drn"][t].contiguous())
        for k, v in (("obs", obs.t()), ("rew", rew[0]), ("done", msk[0] != 0), ("comp", cmp.t())):
            got[k].append(v.numpy())
    got = {k: np.stack(v) for k, v in got.items()}
    np.testing.assert_array_equal(got["done"], golden["done"])
    np.testing.assert_allclose(got["obs"], golden["obs"], rtol=0, atol=2e-4)
    np.testing.assert_allclose(got["rew"], golden["rew"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["comp"], golden["comp"], rtol=0, atol=1e-3)


def test_fused_step_source_matches_plain(host_libs, contact_state):
    env, fused, fs, g = contact_state
    n = 64
    act_T = (torch.rand(n, env.num_actions, generator=g) * 2 - 1).t().contiguous()
    reset, dr = env.draw_samples(n, fs.difficulty)
    rst, drn = fused.operand_rows(reset, dr, n, "cpu")
    rf, ri, rf2, ri2 = fs.rows_f.clone(), fs.rows_i.clone(), fs.rows_f.clone(), fs.rows_i.clone()
    host = _host_fused(host_libs["fused_step"], env, fused, rf, ri, act_T, rst, drn)
    spw = env._spawn[:, None].expand(3, n).contiguous()
    plain = fused.kernel_plain(rf2, ri2, act_T, rst, drn, spw)
    assert torch.equal(host[3], plain[3])
    assert torch.equal(ri, ri2)
    for h, p, atol in ((rf, rf2, 1e-3), (host[0], plain[0], 1e-2), (host[1], plain[1], 2e-4),
                       (host[2], plain[2], 1e-3), (host[4], plain[4], 1e-3)):
        torch.testing.assert_close(h, p, rtol=1e-4, atol=atol)


@pytest.fixture(scope="module")
def small_state():
    """8 envs of the golden scenario (2 substeps) after 2 plain steps of
    random actions, and the operands of one more step."""
    env = make_env(load_config(list(gs.CONFIG)), seed=5, device="cpu")
    fused = env.make_fused()
    fs, _ = fused.reset()
    g = torch.Generator().manual_seed(6)
    n = env.num_envs
    for _ in range(2):
        fs, *_ = fused.step_fn(fs, torch.rand(n, env.num_actions, generator=g) * 2 - 1)
    # half the envs at their last step: the reset merge and projection run
    fs.rows_i[fused.layout.offs_i["episode_step_count"][0], ::2] = (
        env.comps.term_cfg.max_episode_length - 2)
    act_T = (torch.rand(n, env.num_actions, generator=g) * 2 - 1).t().contiguous()
    reset, dr = env.draw_samples(n, fs.difficulty)
    rst, drn = fused.operand_rows(reset, dr, n, "cpu")
    return env, fused, fs, act_T, rst, drn


def _in_lane_order(lib, reverse, fn):
    lib.lane_order_host(int(reverse))
    try:
        return fn()
    finally:
        lib.lane_order_host(0)


@pytest.mark.parametrize("kernel", ["fused_step", "control_step", "min_site_z"])
def test_warp_phases_independent_of_lane_order(host_libs, small_state, kernel):
    """The host build with its lanes in forward and in reverse order gives
    bitwise-equal outputs: no phase reads what another lane writes in it."""
    env, fused, fs, act_T, rst, drn = small_state
    c, n = env.comps, env.num_envs
    lib = host_libs["fused_step" if kernel == "fused_step" else "control_step"]

    def run():
        if kernel == "fused_step":
            rf, ri = fs.rows_f.clone(), fs.rows_i.clone()
            return [rf, ri, *_host_fused(lib, env, fused, rf, ri, act_T, rst, drn)]
        st = fused.unpack(fs)
        model = _buf(ls.lane_model_array(c.engine, c.physics_steps_per_control, lib))
        spawn = env._spawn[:, None].expand(3, n).contiguous()
        if kernel == "min_site_z":
            out, q = torch.empty(n), st.physics.q.t().contiguous()
            lib.min_site_z_host(model.data_ptr(), q.data_ptr(), spawn.data_ptr(),
                                0b1111111111, out.data_ptr(), n)
            return [out]
        ph = st.physics
        box = torch.cat([ph.box_pos, ph.box_quat, ph.box_linvel, ph.box_angvel], 1)
        ins = [x.float().t().contiguous() for x in (ph.q, ph.qd, st.full_dof_targets)]
        ins += [spawn, box.t().contiguous(), st.dr.rows().contiguous()]
        outs = [torch.empty(r, n) for r in (26, 26, 13, 78, 3, 26 * 19 + 70)]
        lib.control_step_host(model.data_ptr(), *(x.data_ptr() for x in ins),
                              *(o.data_ptr() for o in outs), n)
        return outs

    fwd = _in_lane_order(lib, False, run)
    rev = _in_lane_order(lib, True, run)
    assert all(torch.isfinite(o.float()).all() for o in fwd)
    for a, b in zip(fwd, rev):
        assert torch.equal(a, b)


def test_shared_slot_within_budget(host_libs):
    """Each env's shared-memory slot, as the libraries report it, fits the
    design's stated budget, and a block of envs fits an SM's 227 KB."""
    cs, msz, envs, budget = ls.shared_layout(host_libs["control_step"])
    fs_bytes, fs_envs, fs_budget, in_cap, out_cap = fsm.shared_layout(host_libs["fused_step"])
    assert envs == fs_envs >= 1 and budget == fs_budget
    assert max(cs, msz, fs_bytes) <= budget
    # four blocks of envs (32 envs) and the card's 1 KB per block fit an SM's 228 KB
    assert 4 * (envs * budget + 1024) <= 233472 and envs * 4 == 32
    assert in_cap >= 231 and out_cap >= 104 + 158 + 5 + 39


def test_blind_grasping_slots_unchanged(host_libs):
    """The one-box builds' slots stay as they were: 5,960 bytes per env of K2,
    1,536 of min_site_z, 6,996 of K1 (32 envs per SM on the card)."""
    assert ls.shared_layout(host_libs["control_step"]) == (5960, 1536, 8, 7168)
    assert fsm.shared_layout(host_libs["fused_step"])[:4] == (6996, 8, 7168, 240)


@pytest.mark.parametrize("build,blocks", [("control_step_box2", 4), ("fused_step_stacking", 4),
                                          ("fused_step_base", 4), ("fused_step_reorient", 4),
                                          ("fused_step_inhand", 4), ("fused_step_pushing", 4)])
def test_task_build_slots_within_budget(host_libs, build, blocks):
    """Every task build's slot fits the one-box design's 4 blocks of 8 envs
    per SM (32 envs): the two-box builds too, whose two contact passes share
    one buffer."""
    lib = host_libs[build]
    if build.startswith("control_step"):
        cs, _, envs, budget = ls.shared_layout(lib)
        need = cs
    else:
        need, envs, budget = fsm.shared_layout(lib)[:3]
    assert need <= budget == (233472 // blocks - 1024) // envs


# ---------------------------------------------------------------- the task builds
# K1's task builds, by test id: the configuration each is held on (overrides
# separated by spaces)
MJCF_XML = os.path.join(REPO, "dexrobot_isaac_tpu", "assets",
                        "dexhand021_right_simplified_floating.xml")
SCENES = {"BoxStacking": "task=BoxStacking", "BoxStackingPressed": "task=BoxStacking",
          "BaseTask": "task=BaseTask",
          "BoxReorientation": "task=BoxReorientation",
          "InHandReorientation": "task=InHandReorientation",
          "InHandFingersOnly": "experiments=InHandFingersOnly", "BoxPushing": "task=BoxPushing",
          "BlindGraspingCurriculum": "experiments=BlindGraspingCurriculum",
          "BlindGraspingClearance": "experiments=BlindGraspingClearance",
          "MJCFHand": f"task=BlindGrasping env.handAsset={MJCF_XML}"}


def _scene(task, n=16, seed=3):
    """`task` (a SCENES id) at n envs (2 substeps) after 3 plain steps of
    random actions; for BoxStacking, every other env's pick cube then rests
    on the platform (cube-cube contact) and the rest keep theirs on the
    ground; BoxStackingPressed then lifts the platform of the rest onto a
    finger (`_press_into_box2`)."""
    env = make_env(load_config(SCENES[task].split() + [f"numEnvs={n}", "sim.substeps=2"]),
                   seed=seed, device="cpu")
    fused = env.make_fused()
    fs, _ = fused.reset()
    g = torch.Generator().manual_seed(seed + 1)
    for _ in range(3):
        fs, *_ = fused.step_fn(fs, torch.rand(n, env.num_actions, generator=g) * 2 - 1)
    if env.comps.engine.params.has_box2:
        lay = fused.layout
        top = env.comps.task.plat_size + env.comps.task.box_size / 2 - 0.0015
        b, b2 = lay.offs_f["box_pos"][0], lay.offs_f["box2_pos"][0]
        fs.rows_f[b:b + 2, ::2] = fs.rows_f[b2:b2 + 2, ::2] + 0.005
        fs.rows_f[b + 2, ::2] = top
    if task == "BoxStackingPressed":
        assert bool((_press_into_box2(env, fused, fs).abs().sum((1, 2)) > 0)[1::2].all())
    return env, fused, fs, g


def _press_into_box2(env, fused, fs):
    """Every other env (the odd ones) gets the second cube, unrotated and at
    rest, just over its highest finger sphere and 3 mm into it. Returns the
    plain engine's sphere-vs-second-box forces on the spheres (N, S, 3)."""
    eng, lay = env.comps.engine, fused.layout
    st = fused.unpack(fs)
    ph, n, p = st.physics, fs.rows_f.shape[1], eng.params
    sb, r = eng.t["sphere_body"], eng.t["sphere_radius"]
    kin = eng.fk(ph.q, ph.qd, env._spawn.expand(n, 3))
    sp = kin.body_pos[:, sb] + qm.quat_rotate(kin.body_quat[:, sb], eng.t["sphere_pos"])
    top = torch.where(sb >= NUM_BASE_DOFS, sp[..., 2] + r, -np.inf).argmax(1)
    at = torch.arange(n)
    pos = sp[at, top] + torch.stack([torch.zeros(n), torch.zeros(n),
                                     p.box2_size / 2 + r[top] - 0.003], 1)
    rows = {"box2_pos": pos, "box2_quat": torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(n, 4),
            "box2_linvel": torch.zeros(n, 3), "box2_angvel": torch.zeros(n, 3)}
    for k, v in rows.items():
        o = lay.offs_f[k][0]
        fs.rows_f[o:o + v.shape[1], 1::2] = v[1::2].t()
    ph = fused.unpack(fs).physics
    sv = kin.body_linvel[:, sb] + torch.cross(kin.body_angvel[:, sb],
                                              sp - kin.body_pos[:, sb], dim=-1)
    b2m = p.box2_mass * st.dr.box_mass_scale
    g_kick = torch.tensor([0.0, 0.0, p.gravity * eng.substep_dt])
    return eng._sphere_box(sp, sv, (ph.box2_pos, ph.box2_quat, ph.box2_linvel, ph.box2_angvel),
                           p.box2_size / 2, b2m, eng.box2_inertia * st.dr.box_mass_scale,
                           torch.ones(n, 1), g_kick)[0]


@pytest.fixture(scope="module", params=list(SCENES))
def task_scene(request):
    return _scene(request.param)


def test_control_step_source_matches_plain_on_mjcf_hand(host_libs):
    """K2 on the hand loaded from MJCF against the plain engine, with its
    lanes forward and in reverse bitwise equal."""
    env, fused, fs, _ = _scene("MJCFHand")
    c, n, lib = env.comps, fs.rows_f.shape[1], host_libs["control_step"]
    assert not np.array_equal(c.model.sphere_pos, HandPhysics(device="cpu").model.sphere_pos)
    st = fused.unpack(fs)
    ph, spawn = st.physics, env._spawn.expand(n, 3)
    ref, info, kin = env._plain_control_step(ph, st.full_dof_targets, spawn, st.dr)
    model = _buf(ls.lane_model_array(c.engine, c.physics_steps_per_control, lib))
    Tt = lambda x: x.float().t().contiguous()
    ins = [Tt(ph.q), Tt(ph.qd), Tt(st.full_dof_targets), Tt(spawn), Tt(box_rows(ph, False)),
           st.dr.rows()]

    def run(reverse):
        outs = [torch.empty(r, n) for r in (26, 26, 13, 78, 3, 26 * 19 + 70)]
        _in_lane_order(lib, reverse, lambda: lib.control_step_host(
            model.data_ptr(), *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs), n))
        return outs

    fwd, rev = run(False), run(True)
    assert all(torch.equal(a, b) for a, b in zip(fwd, rev))
    for got, want in ((fwd[0].t(), ref.q), (fwd[1].t(), ref.qd),
                      (fwd[2].t(), box_rows(ref, False)), (fwd[4].t(), info.box_contact_force),
                      (fwd[3].t(), info.body_contact_force.reshape(n, -1)),
                      (ls.unpack_kin(fwd[5], 26, 10).site_pos, kin.site_pos)):
        assert float((got - want).abs().max() / want.abs().max().clamp_min(1e-6)) <= 1e-3
    assert bool((info.body_contact_force.abs().sum((1, 2)) > 0).any())


@pytest.mark.parametrize("scene", ["BoxStacking", "BoxStackingPressed"])
def test_control_step_box2_source_matches_plain(host_libs, scene):
    """K2's two-box build against the plain engine, with its lanes forward
    and in reverse bitwise equal; BoxStackingPressed with finger spheres
    pressed into the second cube (the second pass's sphere forces)."""
    env, fused, fs, _ = _scene(scene)
    c, n, lib = env.comps, fs.rows_f.shape[1], host_libs["control_step_box2"]
    st = fused.unpack(fs)
    ph, spawn = st.physics, env._spawn.expand(n, 3)
    ref, info, kin = env._plain_control_step(ph, st.full_dof_targets, spawn, st.dr)
    model = _buf(ls.lane_model_array(c.engine, c.physics_steps_per_control, lib))
    Tt = lambda x: x.float().t().contiguous()
    ins = [Tt(ph.q), Tt(ph.qd), Tt(st.full_dof_targets), Tt(spawn), Tt(box_rows(ph, True)),
           st.dr.rows()]

    def run(reverse):
        outs = [torch.empty(r, n) for r in (26, 26, 26, 78, 6, 26 * 19 + 70)]
        _in_lane_order(lib, reverse, lambda: lib.control_step_host(
            model.data_ptr(), *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs), n))
        return outs

    fwd, rev = run(False), run(True)
    assert all(torch.equal(a, b) for a, b in zip(fwd, rev))
    want_bf = torch.cat([info.box_contact_force, info.box2_contact_force], 1)
    for got, want in ((fwd[0].t(), ref.q), (fwd[1].t(), ref.qd),
                      (fwd[2].t(), box_rows(ref, True)), (fwd[4].t(), want_bf),
                      (fwd[3].t(), info.body_contact_force.reshape(n, -1)),
                      (ls.unpack_kin(fwd[5], 26, 10).site_pos, kin.site_pos)):
        assert float((got - want).abs().max() / want.abs().max().clamp_min(1e-6)) <= 1e-3
    assert bool((info.box_contact_force[::2, 2] > 0).all())  # the platform holds the cube up


def test_fused_task_source_matches_plain(host_libs, task_scene):
    """Each task build of K1 against the plain fused step (half the envs
    resetting), with its lanes forward and in reverse bitwise equal."""
    env, fused, fs, g = task_scene
    n, lib = fs.rows_f.shape[1], host_libs[fused.build]
    fs.rows_i[fused.layout.offs_i["episode_step_count"][0], ::2] = (
        env.comps.term_cfg.max_episode_length - 2)
    act_T = (torch.rand(n, env.num_actions, generator=g) * 2 - 1).t().contiguous()
    reset, dr = env.draw_samples(n, fs.difficulty)
    rst, drn = fused.operand_rows(reset, dr, n, "cpu")

    def run(reverse):
        rf, ri = fs.rows_f.clone(), fs.rows_i.clone()
        outs = _in_lane_order(lib, reverse, lambda: _host_fused(lib, env, fused, rf, ri, act_T,
                                                                 rst, drn))
        return [rf, ri, *outs]

    fwd, rev = run(False), run(True)
    assert all(torch.equal(a, b) for a, b in zip(fwd, rev))
    rf2, ri2 = fs.rows_f.clone(), fs.rows_i.clone()
    spw = env._spawn[:, None].expand(3, n).contiguous()
    plain = fused.kernel_plain(rf2, ri2, act_T, rst, drn, spw)
    assert torch.equal(fwd[5], plain[3]) and int(plain[3][0].sum()) >= n // 2
    assert torch.equal(fwd[1], ri2)
    for h, p, atol in ((fwd[0], rf2, 1e-3), (fwd[2], plain[0], 1e-2), (fwd[3], plain[1], 2e-4),
                       (fwd[4], plain[2], 1e-3), (fwd[6], plain[4], 1e-3)):
        torch.testing.assert_close(h, p, rtol=1e-4, atol=atol)


# ---------------------------------------------------------------- the staging
EXPERIMENTS = sorted(f[:-5] for f in os.listdir(os.path.join(
    REPO, "dexrobot_isaac_tpu_torch", "cfg", "experiments")) if f.endswith(".json"))


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_every_experiment_fits_its_build(host_libs, experiment):
    """Every shipped experiment's rows fit its K1 build's staging in shared
    memory: the fused step, made with that build's library, builds its
    config record (BlindGraspingClearance's 443 output words included)."""
    env = make_env(load_config([f"experiments={experiment}", "numEnvs=2"]), device="cpu")
    build = fsm.build_for(env.comps.task)
    fused = fsm.build_fused_step(env, lib=host_libs[build])
    in_cap, out_cap = fsm.shared_layout(host_libs[build])[3:]
    lay = fused.layout
    assert lay.rows_f + lay.rows_i + env.num_actions + fused.rst_rows + 7 <= in_cap
    assert lay.rows_c + fused.obs_dim + 5 + len(fused.comp_names) <= out_cap
    if experiment == "BlindGraspingClearance":
        assert lay.rows_c + fused.obs_dim + 5 + len(fused.comp_names) == 443


def test_staging_overflow_is_refused_when_made(host_libs):
    """A configuration past K1's output staging (the Clearance experiment
    with 35 more critic dims) raises FusedUnsupported when the fused step is
    made with the build's library, not at its first launch; the CLI's
    `fused=auto` then trains on the unfused step and `fused=on` raises."""
    cfg = load_config(["experiments=BlindGraspingClearance", "numEnvs=2"])
    cfg["task"]["critic_observation_keys"] = (list(cfg["task"]["critic_observation_keys"])
                                              + ["fingertip_poses_hand"])
    env = make_env(cfg, device="cpu")
    with pytest.raises(FusedUnsupported, match="staging"):
        fsm.build_fused_step(env, lib=host_libs["fused_step"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(env), "make_fused",
                   lambda self: fsm.build_fused_step(self, lib=host_libs["fused_step"]))
        card = torch.device("cuda")  # the CLI's choice on the card (nothing runs there)
        logger = logging.getLogger("dexhand_tpu")
        assert cli.choose_fused_step(env, "auto", card, logger) is None
        with pytest.raises(FusedUnsupported, match="staging"):
            cli.choose_fused_step(env, "on", card, logger)
        assert cli.choose_fused_step(env, "off", card, logger) is None
    ok = make_env(load_config(["experiments=BlindGraspingClearance", "numEnvs=2"]),
                  device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(ok), "make_fused",
                   lambda self: fsm.build_fused_step(self, lib=host_libs["fused_step"]))
        assert cli.choose_fused_step(ok, "auto", card, logger).build == "fused_step"
