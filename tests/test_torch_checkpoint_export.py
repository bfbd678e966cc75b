"""Checkpoints across the two packages, and deployment export (CPU).

(a) `utils/msgpack_read.py` against `msgpack.unpackb` on payloads that cover
    its subset, and against `flax.serialization.msgpack_restore` on files the
    JAX `save_checkpoint` wrote.
(b) A JAX `.ckpt` loads into the port (which imports neither flax nor
    msgpack): `act_deterministic` within 1e-5 of the JAX learner's, the meta
    dict equal, the template's optimizer state kept; the two formats are
    told apart by content, not by name; the CLI evaluates a JAX checkpoint.
(c) `rl/export.py` (the cases of tests/test_export.py on the port): the npz
    policy and the TorchScript module against `act_deterministic` (atol
    1e-5), symmetric and asymmetric; the CLI; the native runtime of
    `native/policy_runtime` built with cmake, against the port's export; a
    JAX checkpoint exported by the JAX package and by the port: the same npz
    arrays and the same `.bin` bytes.
"""

import ctypes
import dataclasses
import os
import shutil

import msgpack
import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from dexrobot_isaac_tpu.rl import checkpoint as jax_ckpt
from dexrobot_isaac_tpu.rl import export as jax_export
from dexrobot_isaac_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from dexrobot_isaac_tpu.rl.ppo import PPOLearner as JaxPPOLearner
from dexrobot_isaac_tpu_torch import convert
from dexrobot_isaac_tpu_torch import train as cli
from dexrobot_isaac_tpu_torch.rl import checkpoint as ckpt
from dexrobot_isaac_tpu_torch.rl import export
from dexrobot_isaac_tpu_torch.rl.ppo import PPOConfig, PPOLearner
from dexrobot_isaac_tpu_torch.rl.running_stats import RunningMeanStd
from dexrobot_isaac_tpu_torch.utils import msgpack_read
from tests.proc import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMAKE_TIMEOUT = 120  # seconds for each cmake step
NUM_OBS, NUM_ACT, NUM_STATES = 12, 4, 3
STATES = [0, NUM_STATES]


# ---------------------------------------------------------------- (a) msgpack
PAYLOADS = {
    "scalars": [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1,
                -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63, 1.5, -2e300],
    "strings": {"s": "x" * 31, "s8": "y" * 200, "s16": "z" * 70000, "utf8": "héllo"},
    "bins": [b"", b"\x00" * 300, b"\x01" * 70000],
    "containers": {str(i): list(range(i)) for i in range(20)},
    "nested": {"a": {"b": {"c": [1, [2, [3, {}]]]}}, "e": []},
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_msgpack_reader_matches_msgpack(name):
    data = msgpack.packb(PAYLOADS[name], use_bin_type=True)
    assert msgpack_read.unpackb(data) == msgpack.unpackb(data, raw=False)


def test_msgpack_reader_single_floats_and_flax_ext_types():
    data = msgpack.packb([1.5, -0.25], use_single_float=True)
    assert msgpack_read.unpackb(data) == msgpack.unpackb(data) == [1.5, -0.25]
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4), "i": np.int32(-7),
            "c": 3 + 4j, "e": np.zeros((0, 5)), "b": np.array([True, False]),
            "s": np.float64(2.5)}
    _assert_trees_equal(msgpack_read.unpackb(flax.serialization.msgpack_serialize(tree)),
                        flax.serialization.msgpack_restore(
                            flax.serialization.msgpack_serialize(tree)))


def test_msgpack_reader_rejects_what_flax_never_writes():
    with pytest.raises(ValueError, match="type byte"):
        msgpack_read.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="ext type"):
        msgpack_read.unpackb(msgpack.packb(msgpack.ExtType(9, b"x")))
    with pytest.raises(ValueError, match="after"):
        msgpack_read.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="ends"):
        msgpack_read.unpackb(msgpack.packb("abc")[:-1])


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


# ---------------------------------------------------------------- checkpoints
def _dummy_env_step(state, actions):
    key, obs = state
    key, sub = jax.random.split(key)
    new_obs = jax.random.normal(sub, obs.shape)
    done = jnp.zeros(obs.shape[0], dtype=bool)
    return (key, new_obs), new_obs, -jnp.sum(actions ** 2, axis=-1), done, {"timeout": done}


def make_jax_ckpt(path, num_states, num_obs=NUM_OBS, num_act=NUM_ACT, units=(16, 16),
                  meta=None):
    """A JAX learner's state with non-trivial normalization, saved by the
    JAX `save_checkpoint`."""
    learner = JaxPPOLearner(JaxPPOConfig(
        num_actions=num_act, num_obs=num_obs, num_states=num_states, num_envs=8,
        horizon_length=4, minibatch_size=8, mini_epochs=1, units=units), _dummy_env_step, seed=3)
    st = learner.init_state()
    width = num_obs + num_states
    st = dataclasses.replace(st, obs_rms=dataclasses.replace(
        st.obs_rms, mean=jnp.linspace(-1.0, 1.0, width), var=jnp.linspace(0.5, 2.0, width)),
        lr=jnp.asarray(2.5e-4, jnp.float32), epoch=jnp.asarray(7, jnp.int32))
    jax_ckpt.save_checkpoint(str(path), st, meta if meta is not None
                             else {"iteration": 7, "difficulty": 0.35, "reward": -1.25})
    return learner, st


def _port_learner(num_states, units=(16, 16)):
    return PPOLearner(PPOConfig(num_actions=NUM_ACT, num_obs=NUM_OBS, num_states=num_states,
                                num_envs=8, units=units), None, seed=5, device="cpu")


@pytest.fixture(scope="module", params=STATES, ids=["symmetric", "asymmetric"])
def jax_file(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ckpt") / "policy.ckpt"
    learner, st = make_jax_ckpt(path, request.param)
    return request.param, learner, st, str(path)


def test_reader_matches_flax_on_a_jax_checkpoint(jax_file):
    _, _, _, path = jax_file
    with open(path, "rb") as f:
        data = f.read()
    _assert_trees_equal(msgpack_read.unpackb(data), flax.serialization.msgpack_restore(data))


def test_jax_checkpoint_loads_into_the_port(jax_file):
    num_states, jlearner, jst, path = jax_file
    learner = _port_learner(num_states)
    template = learner.init_state()
    st = ckpt.load_checkpoint(path, template, learner)
    assert st.opt_state is template.opt_state
    assert float(st.lr) == pytest.approx(2.5e-4) and int(st.epoch) == 7
    assert st.epoch.dtype == template.epoch.dtype and st.lr.dtype == torch.float32
    obs = np.random.default_rng(0).normal(size=(6, NUM_OBS + num_states)).astype(np.float32)
    want = np.asarray(jlearner.act_deterministic(jst, jnp.asarray(obs)))
    got = learner.act_deterministic(st, torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    params = convert.actor_critic_from_flax(jax.device_get(jst.params), "cpu")
    assert sorted(params) == sorted(st.params)
    for k, v in params.items():
        assert torch.equal(st.params[k], v), k


def test_jax_checkpoint_meta_equals_jax(jax_file):
    _, _, _, path = jax_file
    assert ckpt.load_checkpoint_meta(path) == jax_ckpt.load_checkpoint_meta(path)
    assert ckpt.load_checkpoint_meta(path) == {"iteration": 7, "difficulty": 0.35,
                                               "reward": -1.25}


def test_formats_told_apart_by_content(jax_file, tmp_path):
    num_states, _, _, path = jax_file
    learner = _port_learner(num_states)
    named_pt = tmp_path / "jax_file.pt"
    shutil.copy(path, named_pt)
    a = ckpt.load_checkpoint(path, learner.init_state())
    b = ckpt.load_checkpoint(str(named_pt), learner.init_state())
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    port_file = tmp_path / "port_file.ckpt"
    ckpt.save_checkpoint(str(port_file), a, {"iteration": 1}, learner)
    c = ckpt.load_checkpoint(str(port_file), learner.init_state(), learner)
    assert all(torch.equal(a.params[k], c.params[k]) for k in a.params)
    assert ckpt.load_checkpoint_meta(str(port_file)) == {"iteration": 1}
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(msgpack.packb([1, 2]))
    with pytest.raises(ValueError, match="neither"):
        ckpt.load_checkpoint(str(junk), learner.init_state())


CLI_ARGS = ["device=cpu", "task=BlindGrasping", "numEnvs=4", "env.episodeLength=4",
            "sim.substeps=1", "sim.physics_steps_per_control=1", "train.logging.noLogFile=true",
            "train.params.network.units=[32,32]"]


def test_cli_evaluates_a_jax_checkpoint(tmp_path, monkeypatch):
    """`train.py test=true checkpoint=<a JAX .ckpt>`: the port loads the JAX
    policy and evaluates it on the unfused step."""
    monkeypatch.setenv("DEXHAND_RUNS_DIR", str(tmp_path))
    path = tmp_path / "BlindGrasping.ckpt"
    _, jst = make_jax_ckpt(path, 0, num_obs=158, num_act=18, units=(32, 32))
    s = cli.build(cli.load_config(CLI_ARGS + ["test=true", f"checkpoint={path}",
                                              "testGamesNum=4"]))
    want = convert.actor_critic_from_flax(jax.device_get(jst.params), "cpu")
    assert all(torch.equal(s.ppo.params[k], v) for k, v in want.items())
    np.testing.assert_array_equal(s.ppo.obs_rms.mean.numpy(), np.asarray(jst.obs_rms.mean))
    assert s.resume_meta["iteration"] == 7
    assert cli.run_test(s) == 0 and s.stats[-1]["episodes"] >= 4


# ---------------------------------------------------------------- (c) export
def make_port_ckpt(path, num_states):
    learner = _port_learner(num_states)
    st = learner.init_state()
    width = NUM_OBS + num_states
    st = dataclasses.replace(st, obs_rms=RunningMeanStd(
        torch.linspace(-1.0, 1.0, width), torch.linspace(0.5, 2.0, width),
        torch.tensor(10.0)))
    ckpt.save_checkpoint(str(path), st, {"iteration": 1}, learner)
    return learner, st


@pytest.fixture(params=STATES, ids=["symmetric", "asymmetric"])
def port_file(request, tmp_path):
    learner, st = make_port_ckpt(tmp_path / "policy.pt", request.param)
    return request.param, learner, st, str(tmp_path / "policy.pt")


def _obs(seed, num_states):
    return np.random.default_rng(seed).normal(size=(5, NUM_OBS + num_states)).astype(np.float32)


def test_npz_matches_act_deterministic(port_file, tmp_path):
    num_states, learner, st, path = port_file
    policy = export.NumpyPolicy.load(export.export_npz(path, str(tmp_path / "policy.npz")))
    assert policy.num_obs == NUM_OBS
    obs = _obs(0, num_states)
    ref = learner.act_deterministic(st, torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(policy(obs), ref, atol=1e-5)
    np.testing.assert_allclose(policy(obs[:, :NUM_OBS]), ref, atol=1e-5)  # policy slice only


def test_torchscript_matches(port_file, tmp_path):
    num_states, learner, st, path = port_file
    module = torch.jit.load(export.export_torchscript(path, str(tmp_path / "actor.pt")))
    obs = _obs(1, num_states)
    ref = learner.act_deterministic(st, torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(module(torch.as_tensor(obs)).detach().numpy(), ref, atol=1e-5)


def test_export_is_float32_under_a_bf16_network(tmp_path):
    learner = PPOLearner(PPOConfig(num_actions=NUM_ACT, num_obs=NUM_OBS, num_envs=8,
                                   units=(16, 16), network_dtype="bfloat16"), None, seed=5,
                         device="cpu")
    ckpt.save_checkpoint(str(tmp_path / "bf16.pt"), learner.init_state(), {}, learner)
    w = export.extract_actor(str(tmp_path / "bf16.pt"))
    assert all(v.dtype in (np.float32, np.int64) for v in w.values())


def test_cli(tmp_path):
    make_port_ckpt(tmp_path / "ckpt.pt", 0)
    path = str(tmp_path / "ckpt.pt")
    assert export.main([path]) == 0 and (tmp_path / "ckpt.npz").exists()
    assert export.main([path, "--format", "torchscript"]) == 0
    assert (tmp_path / "ckpt.torchscript.pt").exists()
    assert export.main([path, "--format", "bin"]) == 0 and (tmp_path / "ckpt.bin").exists()
    assert export.main([path, "--format", "npz", "--out", str(tmp_path / "x.npz")]) == 0
    assert (tmp_path / "x.npz").exists()
    assert ckpt.load_checkpoint_meta(path) == {"iteration": 1}  # the checkpoint is intact


def test_jax_checkpoint_exports_identically(jax_file, tmp_path):
    """The JAX package's export and the port's of one JAX checkpoint: equal
    npz arrays, equal `.bin` bytes."""
    _, _, _, path = jax_file
    want, got = jax_export.extract_actor(path), export.extract_actor(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    a = jax_export.export_flat_binary(path, str(tmp_path / "jax.bin"))
    b = export.export_flat_binary(path, str(tmp_path / "port.bin"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.fixture(scope="module")
def native_runtime(tmp_path_factory):
    """native/policy_runtime built with cmake, as tests/test_export.py
    builds it."""
    if shutil.which("cmake") is None:
        pytest.skip("cmake not available")
    build = tmp_path_factory.mktemp("native") / "build"
    src = os.path.join(REPO, "native", "policy_runtime")
    run(["cmake", "-S", src, "-B", str(build)], timeout=CMAKE_TIMEOUT)
    run(["cmake", "--build", str(build)], timeout=CMAKE_TIMEOUT)
    lib = ctypes.CDLL(str(build / "libdex_policy.so"))
    lib.dex_policy_load.restype = ctypes.c_void_p
    lib.dex_policy_load.argtypes = [ctypes.c_char_p]
    fp = ctypes.POINTER(ctypes.c_float)
    lib.dex_policy_act.argtypes = [ctypes.c_void_p, fp, ctypes.c_int, fp]
    lib.dex_policy_num_obs.argtypes = [ctypes.c_void_p]
    lib.dex_policy_num_actions.argtypes = [ctypes.c_void_p]
    lib.dex_policy_free.argtypes = [ctypes.c_void_p]
    return lib


def test_native_runtime_matches(port_file, native_runtime, tmp_path):
    num_states, learner, st, path = port_file
    lib = native_runtime
    handle = lib.dex_policy_load(export.export_flat_binary(path, str(tmp_path / "p.bin")).encode())
    assert handle, "dex_policy_load failed"
    try:
        assert lib.dex_policy_num_obs(handle) == NUM_OBS
        assert lib.dex_policy_num_actions(handle) == NUM_ACT
        obs = np.ascontiguousarray(_obs(2, num_states)[:, :NUM_OBS])
        full = np.concatenate([obs, np.zeros((5, num_states), np.float32)], axis=1)
        ref = learner.act_deterministic(st, torch.as_tensor(full)).numpy()
        out = np.empty((5, NUM_ACT), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        assert lib.dex_policy_act(handle, obs.ctypes.data_as(fp), 5, out.ctypes.data_as(fp)) == 0
        np.testing.assert_allclose(out, ref, atol=1e-5)
    finally:
        lib.dex_policy_free(handle)
