"""The CUDA kernels' arithmetic, built for the host and held to the plain
versions (CPU).

`csrc/control_step.cu` and `csrc/fused_step.cu` also compile as plain C++
(their per-env code is __device__ only under nvcc), so g++ builds the same
per-env functions into host libraries with a loop over envs. The wrappers
never run these: on a CPU tensor they run the plain versions, on a CUDA
tensor the nvcc-built kernels. This checks the kernel source here, where no
card is: the struct layouts the wrappers fill, K2 and min_site_z against the
plain engine, and K1 against the TPU-recorded golden trajectory (obs atol
2e-4, reward/components atol 1e-3, done exact) and the plain fused step.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from dexrobot_isaac_tpu_torch.envs import fused_step as fsm
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.physics import lane_step as ls
from dexrobot_isaac_tpu_torch.physics.engine import HandPhysics
from dexrobot_isaac_tpu_torch.physics.types import SimParams
from dexrobot_isaac_tpu_torch.utils.config import load_config
from dexrobot_isaac_tpu_torch.utils.kernel_build import CSRC
from tests import golden_scenario as gs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.as_tensor
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    for name in ("control_step", "fused_step"):
        so = str(out / f"{name}.so")
        subprocess.run(["g++", "-x", "c++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so,
                        os.path.join(CSRC, name + ".cu")], check=True, timeout=300)
        libs[name] = ctypes.CDLL(so)
    libs["control_step"].control_step_host.argtypes = [P] * 13 + [I]
    libs["control_step"].min_site_z_host.argtypes = [P, P, P, I, P, I]
    libs["fused_step"].fused_step_host.argtypes = [P] * 13 + [I]
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
])
def test_struct_layouts_match_the_wrappers(host_libs, contact_state, lib, fn):
    """The dtype read from a library's layout export tiles the struct with
    4-byte fields and no gaps, both libraries agree on LaneModel, and the
    wrapper fills every field it names (numpy raises on a missing one)."""
    dt = ls.struct_dtype(getattr(host_libs[lib], fn))
    fields = sorted(dt.fields.values(), key=lambda f: f[1])
    ends = [off + f.itemsize for f, off in fields]
    assert [off for _, off in fields] == [0] + ends[:-1] and ends[-1] == dt.itemsize
    assert all(f.base in (np.dtype("f4"), np.dtype("i4")) for f, _ in fields)
    env, fused, _, _ = contact_state
    if fn == "lane_model_layout":
        assert dt == ls.struct_dtype(host_libs["control_step"].lane_model_layout)
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
