"""The port's graphics sidecar (`dexrobot_isaac_tpu_torch/graphics/`) held
against the JAX package's on the CPU, at small sizes (160x120 to 320x240,
4 envs), with the same inputs made from a numpy seed:

- the rasterizer (spheres, a mesh, a capsule, a box, the ground; two
  cameras) and `SceneRenderer.render_state` (box, second box, contact
  forces; visual geometry and the collision-impostor path): frames
  bitwise equal;
- `HandModel.visual_geoms` of the built-in hand and of the MJCF loader
  (the vendored hand and a file with visual primitives): equal (atol 0);
- frames from the JAX FK's poses and the port's `HandPhysics.fk` on the
  same q: at most 0.05% of the pixels differ; `env_rows` (FK of one env)
  gives the frame of the FK of every env, bit for bit;
- the viewer's keys, frames and matplotlib window, the streamer's
  endpoints and key channel,
  the live charts, an mp4 through `VideoRecorder` (the cases of
  tests/test_graphics.py, each held on the port);
- the E key's masked reset: only the selected env changes, and with the
  JAX reset's draws as operands its rows equal those of JAX's merge
  (`train.py:630-649`) within 1e-6;
- the CLI's evaluation with `env.videoRecord`, `env.videoStream` and
  `env.viewer` (keys sent through `/control`). The harness's `videoRecord`,
  `plot` and `live` (the mp4, the PNG, a `/data` series) are held in
  tests/test_torch_tools.py, one case each.

HTTP ports 18400-18499 (tests/test_graphics.py binds 181xx on another
worker).
"""

import dataclasses
import logging
import os
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dexrobot_isaac_tpu.factory import make_env as jax_make_env
from dexrobot_isaac_tpu.graphics import raster as jax_raster
from dexrobot_isaac_tpu.graphics import renderer as jax_renderer
from dexrobot_isaac_tpu.graphics import streamer as jax_streamer
from dexrobot_isaac_tpu.graphics import viewer as jax_viewer
from dexrobot_isaac_tpu.models.dexhand021 import build_hand_model as jax_hand_model
from dexrobot_isaac_tpu.models.mjcf import load_mjcf as jax_load_mjcf
from dexrobot_isaac_tpu.utils.config import load_config as jax_load_config
from dexrobot_isaac_tpu_torch import convert
from dexrobot_isaac_tpu_torch import train as cli
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.graphics import raster, renderer, streamer, viewer
from dexrobot_isaac_tpu_torch.graphics.liveplot import LivePlotServer
from dexrobot_isaac_tpu_torch.graphics.video import VideoRecorder
from dexrobot_isaac_tpu_torch.models.dexhand021 import build_hand_model
from dexrobot_isaac_tpu_torch.models.mjcf import load_mjcf
from dexrobot_isaac_tpu_torch.utils.config import load_config
from tests.torch_parity import assert_visual_geoms_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VENDORED_XML = os.path.join(REPO, "dexrobot_isaac_tpu", "assets",
                            "dexhand021_right_simplified_floating.xml")
RES = (320, 240)
SEED = 3
T = torch.as_tensor


def _get(url):
    return urllib.request.urlopen(url, timeout=5)


def _random_q(rng, n, model):
    lo, hi = np.asarray(model.lower_limit), np.asarray(model.upper_limit)
    return (lo + (hi - lo) * rng.uniform(0.2, 0.8, (n, len(lo)))).astype(np.float32)


MASK_CONFIG = ["task=BlindGrasping", "numEnvs=4", "sim.substeps=1",
               "sim.physics_steps_per_control=2"]


@pytest.fixture(scope="module")
def jax_env():
    return jax_make_env(jax_load_config(MASK_CONFIG), seed=SEED)


@pytest.fixture(scope="module")
def port_env_state():
    """The port's BoxStacking env (the built-in hand, the second box) at 4
    envs after one step of random actions."""
    env = make_env(load_config(["task=BoxStacking", "numEnvs=4", "sim.substeps=1",
                                "sim.physics_steps_per_control=1"]), seed=SEED, device="cpu")
    state, _ = env.reset_fn()
    acts = torch.rand(4, env.num_actions, generator=torch.Generator().manual_seed(SEED)) * 2 - 1
    state, *_ = env.step_fn(state, acts)
    return env, state


@pytest.fixture(scope="module")
def poses(jax_env, port_env_state):
    """Body poses of 4 random hand poses from the JAX FK and from the
    port's, with box and contact rows, as numpy."""
    rng = np.random.default_rng(SEED)
    model = jax_hand_model()
    q = _random_q(rng, 4, model)
    q[:, :3] = rng.uniform(-0.05, 0.05, (4, 3))
    spawn = np.tile(np.array([[0.0, 0.0, 0.25]], np.float32), (4, 1))
    jkin = jax.vmap(jax_env.comps.engine.fk)(jnp.asarray(q), jnp.zeros_like(jnp.asarray(q)),
                                             jnp.asarray(spawn))
    tkin = port_env_state[0].comps.engine.fk(T(q), torch.zeros(4, 26), T(spawn))
    force = rng.normal(0.0, 3.0, (4, model.num_bodies, 3)).astype(np.float32)
    force[:, :10] = 0.0
    quat = rng.normal(size=(4, 4)).astype(np.float32)
    return dict(
        jax=(np.asarray(jkin.body_pos), np.asarray(jkin.body_quat)),
        port=(tkin.body_pos.numpy(), tkin.body_quat.numpy()),
        box_pos=np.array([0.1, 0.0, 0.025], np.float32),
        box_quat=np.array([0.0, 0.0, 0.0, 1.0], np.float32),
        box2_pos=np.array([-0.02, 0.12, 0.04], np.float32),
        box2_quat=quat[0] / np.linalg.norm(quat[0]),
        force=force)


# ---------------------------------------------------------------- rasterizer
@pytest.mark.parametrize("camera", [((0.7, -0.7, 0.55), (0.05, 0.0, 0.15)),
                                    ((0.05, 0.0, 1.2), (0.05, 0.0, 0.15))])
def test_rasterizer_frames_equal_jax(camera):
    rng = np.random.default_rng(SEED)
    centers = rng.uniform(-0.1, 0.2, (12, 3))
    radii = rng.uniform(0.005, 0.03, 12)
    colors = rng.uniform(0.2, 1.0, (12, 3))
    verts = rng.uniform(-0.1, 0.1, (5, 3)) + [0.05, 0.0, 0.1]
    faces = [(0, 1, 2), (1, 2, 3), (2, 3, 4), (0, 3, 4)]
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    frames = []
    for mod in (jax_raster, raster):
        r = mod.Rasterizer((160, 120))
        for _ in range(2):  # the second frame takes the ground cache
            r.begin(*camera)
            r.spheres(centers, radii, colors)
            r.mesh(verts, faces, (0.7, 0.3, 0.3))
            r.capsule((0.0, 0.05, 0.05), (0.1, -0.05, 0.2), 0.012, (0.5, 0.6, 0.7))
            r.box((0.1, 0.0, 0.025), rot, (0.025, 0.03, 0.02), (0.45, 0.68, 0.95))
            r.ground()
            frames.append(r.finish())
    assert frames[0].std() > 5.0
    for a, b in zip(frames[:2], frames[2:]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- visual geoms
def test_builtin_visual_geoms_equal_jax():
    got = build_hand_model().visual_geoms
    assert [g[0] for g in got] == ["box"] + ["capsule"] * 20
    assert_visual_geoms_equal(got, jax_hand_model().visual_geoms)


_VISUAL_XML = """<mujoco><compiler angle="degree" autolimits="true"/>
<default><default class="visual"><geom contype="0" conaffinity="0"/></default></default>
<worldbody><body name="base" pos="0 0 0.1">
  <joint name="j0" type="hinge" axis="0 0 1" range="-90 90"/>
  <geom type="sphere" size="0.02" pos="0 0 0.01"/>
  <geom class="visual" type="sphere" size="0.015" pos="0.01 0 0"/>
  <geom class="visual" type="capsule" size="0.01" fromto="0 0 0 0.05 0.01 0.02"/>
  <geom class="visual" type="capsule" size="0.008 0.03" pos="0 0.02 0"/>
  <geom class="visual" type="box" size="0.02 0.01 0.005" pos="0.03 0 0" euler="10 20 30"/>
  <geom type="box" size="0.02 0.02 0.02" contype="0" conaffinity="0" quat="0.9 0 0.1 0"/>
  <geom class="visual" type="mesh" mesh="palm"/>
  <body name="link" pos="0.05 0 0"><joint name="j1" type="slide" axis="1 0 0" range="0 0.02"/>
    <geom type="capsule" size="0.01" fromto="0 0 0 0.03 0 0"/>
    <geom class="visual" type="capsule" size="0.009" fromto="0 0 0 0.03 0 0"/>
  </body>
</body></worldbody></mujoco>"""


@pytest.mark.parametrize("which", ["vendored", "visual_primitives"])
def test_mjcf_visual_geoms_equal_jax(tmp_path, which):
    path = VENDORED_XML
    if which == "visual_primitives":
        path = str(tmp_path / "visual.xml")
        with open(path, "w") as f:
            f.write(_VISUAL_XML)
    got, want = load_mjcf(path), jax_load_mjcf(path)
    assert_visual_geoms_equal(got.visual_geoms, want.visual_geoms)
    if which == "visual_primitives":
        assert [g[0] for g in got.visual_geoms] == ["sphere", "capsule", "capsule", "box",
                                                    "box", "capsule"]


# ---------------------------------------------------------------- renderer
@pytest.mark.parametrize("path", ["visual_geoms", "impostors"])
def test_render_state_equals_jax(poses, path):
    body_pos, body_quat = poses["jax"]
    frames = []
    for mod, model in ((jax_renderer, jax_hand_model()), (renderer, build_hand_model())):
        r = mod.SceneRenderer(model, resolution=RES)
        if path == "impostors":
            r._vgeoms = []
        cf = np.linalg.norm(poses["force"][1], axis=-1)
        frames.append(r.render_state(
            body_pos[1], body_quat[1], box_pos=poses["box_pos"], box_quat=poses["box_quat"],
            contact_force_bodies=cf, title="env 1", box2_pos=poses["box2_pos"],
            box2_quat=poses["box2_quat"], box2_size=0.08))
    assert frames[0].shape == (240, 320, 3) and frames[0].std() > 5.0
    np.testing.assert_array_equal(frames[1], frames[0])


@pytest.mark.parametrize("e", range(4))
def test_frames_from_jax_and_port_fk_agree(poses, e):
    r = renderer.SceneRenderer(build_hand_model(), resolution=RES)
    f_jax, f_port = (r.render_state(*(x[e] for x in poses[k]), box_pos=poses["box_pos"],
                                    box_quat=poses["box_quat"]) for k in ("jax", "port"))
    off = int((f_jax != f_port).any(-1).sum())
    assert off <= 0.0005 * RES[0] * RES[1], off


def test_env_rows_of_one_env_give_the_frame_of_all_envs(port_env_state):
    env, state = port_env_state
    ph, force = state.physics, state.body_contact_force
    kin = env.comps.engine.fk(ph.q, ph.qd, env._spawn.expand(4, 3))
    one = renderer.env_rows(env.comps.engine, ph, env._spawn, force, 2)
    every = renderer.EnvRows.select(kin, ph, force, 2)
    for f in dataclasses.fields(renderer.EnvRows):
        np.testing.assert_array_equal(getattr(one, f.name), getattr(every, f.name), f.name)
    r = renderer.SceneRenderer(env.comps.model, resolution=RES,
                               box_size=env.comps.engine.params.box_size)
    frames = [rows.render(r, "env 2", box2_size=env.comps.engine.params.box2_size)
              for rows in (one, every)]
    np.testing.assert_array_equal(frames[0], frames[1])
    # the second box is drawn: the frame without it differs
    no_box2 = dataclasses.replace(one, box2_pos=None)
    assert (no_box2.render(r, "env 2") != frames[0]).any()


# ---------------------------------------------------------------- viewer
class _FrameSink:
    def __init__(self):
        self.frames = []
        self.on_key = None

    def add_frame(self, f):
        self.frames.append(f)


def _viewers(calls):
    out = []
    for mod, rmod, model in ((jax_viewer, jax_renderer, jax_hand_model()),
                             (viewer, renderer, build_hand_model())):
        out.append(mod.ViewerController(
            rmod.SceneRenderer(model, resolution=(160, 120)), num_envs=4,
            on_reset_env=lambda i, m=mod: calls.append((m.__name__, "reset", i)),
            on_toggle_random_actions=lambda m=mod: calls.append((m.__name__, "random")),
            box2_size=0.08))
    return out


def _viewer_state(v):
    return (v.selected_env, v.view_mode_idx, v.follow, v.show_contacts)


def _calls_of(calls, mod):
    return [c[1:] for c in calls if c[0] == mod.__name__]


def test_viewer_key_table_equals_jax():
    calls = []
    jv, tv = _viewers(calls)
    assert viewer.VIEW_MODES == jax_viewer.VIEW_MODES
    for k in ["enter"] * 4 + ["f", "f", "up", "down", "down", "e", " ", "c", "x", "enter",
                              "f", "e"]:
        jv.handle_key(k)
        tv.handle_key(k)
        assert _viewer_state(tv) == _viewer_state(jv), k
    assert _viewer_state(tv) == (3, 1, True, False)
    assert _calls_of(calls, viewer) == _calls_of(calls, jax_viewer) == [
        ("reset", 3), ("random",), ("reset", 3)]


def test_viewer_push_and_drain_keys_equals_jax():
    calls = []
    jv, tv = _viewers(calls)
    for k in ("Enter", "ArrowUp", "ArrowUp", "e", " ", "F", "spacebar", "ArrowDown"):
        jv.push_key(k)
        tv.push_key(k)
    assert _viewer_state(tv) == (0, 0, False, True) and not calls  # nothing applied yet
    jv.drain_keys()
    tv.drain_keys()
    assert _viewer_state(tv) == _viewer_state(jv) == (1, 1, True, True)
    assert _calls_of(calls, viewer) == _calls_of(calls, jax_viewer) == [
        ("reset", 2), ("random",), ("random",)]
    assert not tv._pending


def test_viewer_autowires_streamer_on_key():
    sink = _FrameSink()
    v = viewer.ViewerController(renderer.SceneRenderer(build_hand_model(), (160, 120)), 2,
                                streamer=sink)
    assert sink.on_key == v.push_key


def test_viewer_render_equals_jax(poses):
    calls = []
    jv, tv = _viewers(calls)
    kin = type("Kin", (), {"body_pos": poses["jax"][0], "body_quat": poses["jax"][1]})
    phys = type("Phys", (), {"box_pos": np.tile(poses["box_pos"], (4, 1)),
                             "box_quat": np.tile(poses["box_quat"], (4, 1)),
                             "box2_pos": np.tile(poses["box2_pos"], (4, 1)),
                             "box2_quat": np.tile(poses["box2_quat"], (4, 1))})
    frames = []
    for v in (jv, tv):
        v.streamer = _FrameSink()
        for k in ("ArrowUp", "ArrowUp", "Enter"):
            v.push_key(k)
        frames.append(v.render(kin, phys, body_contact_force=poses["force"]))
        assert v.selected_env == 2 and len(v.streamer.frames) == 1
    np.testing.assert_array_equal(frames[1], frames[0])


def test_viewer_window_shows_the_frame(poses):
    """Without a streamer the frame goes to a matplotlib window (Agg here:
    no display), keys from it reach handle_key, and close() closes it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    v = viewer.ViewerController(renderer.SceneRenderer(build_hand_model(), (160, 120)), 4)
    kin = type("Kin", (), {"body_pos": poses["port"][0], "body_quat": poses["port"][1]})
    phys = type("Phys", (), {"box_pos": np.tile(poses["box_pos"], (4, 1)),
                             "box_quat": np.tile(poses["box_quat"], (4, 1)),
                             "box2_pos": None, "box2_quat": None})
    frame = v.render(kin, phys)
    assert v._fig is not None and np.array_equal(np.asarray(v._im.get_array()), frame)
    from matplotlib.backend_bases import KeyEvent

    v._fig.canvas.callbacks.process("key_press_event",
                                    KeyEvent("key_press_event", v._fig.canvas, key="up"))
    assert v.selected_env == 1
    fig = v._fig
    v.close()
    assert v._fig is None and not plt.fignum_exists(fig.number)


# ---------------------------------------------------------------- streamer, charts, mp4
@pytest.fixture(scope="module")
def frame(poses):
    r = renderer.SceneRenderer(build_hand_model(), resolution=RES)
    return r.render_state(*(x[0] for x in poses["port"]), box_pos=poses["box_pos"],
                          box_quat=poses["box_quat"], title="test")


def test_streamer_jpeg_equals_jax(frame):
    got, want = streamer.HTTPVideoStreamer(), jax_streamer.HTTPVideoStreamer()
    got.add_frame(frame)
    want.add_frame(frame)
    assert got._frames[-1] == want._frames[-1] and got.stats()["frames_received"] == 1


def test_streamer_serves_pages_and_stats(frame):
    s = streamer.HTTPVideoStreamer(port=18400)
    s.start()
    try:
        s.add_frame(frame)
        base = f"http://127.0.0.1:{s.port}"
        assert b"DexHand" in _get(base + "/").read()
        assert b'"frames_received": 1' in _get(base + "/stats").read()
        req = _get(base + "/stream")
        s.add_frame(frame)
        chunk = req.read(2000)
        assert b"--frame" in chunk and b"image/jpeg" in chunk
        with pytest.raises(urllib.error.HTTPError):
            _get(base + "/nothing")
    finally:
        s.stop()


def test_streamer_control_forwards_keys_to_the_viewer():
    s = streamer.HTTPVideoStreamer(port=18410)
    v = viewer.ViewerController(renderer.SceneRenderer(build_hand_model(), (160, 120)), 4,
                                streamer=s)
    s.start()
    try:
        base = f"http://127.0.0.1:{s.port}"
        assert b"/control?key=" in _get(base + "/").read()
        assert _get(base + "/control?key=Enter").status == 204
        _get(base + "/control?key=ArrowUp")
        _get(base + "/control?key=%20")
        assert list(v._pending) == ["enter", "up", " "]
        assert b'"keys_received": 3' in _get(base + "/stats").read()
        v.drain_keys()
        assert (v.view_mode_idx, v.selected_env) == (1, 1)
    finally:
        s.stop()


def test_streamer_port_auto_increment():
    s1 = streamer.HTTPVideoStreamer(port=18420)
    s1.start()
    s2 = streamer.HTTPVideoStreamer(port=18420)
    s2.start()
    try:
        assert s2.port == s1.port + 1
    finally:
        s1.stop()
        s2.stop()


def test_liveplot_ring_and_data():
    import json

    s = LivePlotServer(port=18440, maxlen=8)
    s.start()
    try:
        for i in range(12):
            s.log("reward", float(i))
        s.log_many({"dof": 0.5, "contacts": 2.0})
        base = f"http://127.0.0.1:{s.port}"
        page = _get(base + "/").read()
        assert b"live series" in page and b"/data" in page
        data = json.loads(_get(base + "/data").read())
        assert data["reward"] == [float(i) for i in range(4, 12)]
        assert data["dof"] == [0.5] and data["contacts"] == [2.0]
    finally:
        s.stop()


def test_liveplot_port_auto_increment():
    s1 = LivePlotServer(port=18450)
    s1.start()
    s2 = LivePlotServer(port=18450)
    s2.start()
    try:
        assert s2.port == s1.port + 1
    finally:
        s1.stop()
        s2.stop()


def test_video_recorder_writes_mp4(frame, tmp_path):
    rec = VideoRecorder(str(tmp_path), max_duration_seconds=10)
    rec.finalize_fps(0.04)
    assert rec.fps == pytest.approx(25.0) and rec.max_frames == 250
    rec.start_episode()
    for _ in range(5):
        rec.add_frame(frame)
    rec.stop_episode()
    rec.close()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".mp4")]
    assert files == ["episode_00001.mp4"]
    assert os.path.getsize(tmp_path / files[0]) > 1000


# ---------------------------------------------------------------- E key
def _jax_masked_reset(env, state, key, env_idx):
    """JAX train.py:630-649: a fresh reset merged into env `env_idx`'s rows
    of every leaf whose leading dimension is the env count."""
    fresh, _ = env._reset_jit(key)
    mask = jnp.arange(env.num_envs) == env_idx

    def merge(new, cur):
        if getattr(new, "ndim", 0) >= 1 and new.shape[0] == env.num_envs:
            return jnp.where(mask.reshape((env.num_envs,) + (1,) * (new.ndim - 1)), new, cur)
        return cur

    return jax.tree.map(merge, fresh, state)


@pytest.fixture(scope="module")
def masked(jax_env):
    jenv = jax_env
    state, _ = jenv._reset_jit(jax.random.key(SEED))
    key = jax.random.key(SEED + 1)
    want = jax.device_get(_jax_masked_reset(jenv, state, key, 2))
    _, task_key, _ = jax.random.split(key, 3)
    sample = jax.device_get(jenv.comps.task.reset_task(
        task_key, 4, jenv._default_dof,
        difficulty=jnp.asarray(jenv.comps.initial_difficulty, jnp.float32), project=False))
    env = make_env(load_config(MASK_CONFIG), seed=SEED, device="cpu")
    before = convert.env_state(jax.device_get(state), "cpu")
    got = cli.masked_reset(env, before, 2, samples=(convert.task_reset(sample, "cpu"), None))
    return before, got, convert.env_state(want, "cpu")


def _leaves(state):
    out = {}

    def walk(x, name):
        if isinstance(x, torch.Tensor):
            out[name] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{name}.{k}")
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{name}.{f.name}")

    walk(state, "state")
    return out


def test_masked_reset_changes_the_selected_env_only(masked):
    before, got, _ = masked
    b, g = _leaves(before), _leaves(got)
    assert sorted(b) == sorted(g)
    changed = False
    for k, v in g.items():
        if v.ndim == 0 or v.shape[0] != 4:
            assert torch.equal(v, b[k]), k
            continue
        keep = torch.tensor([True, True, False, True])
        assert torch.equal(v[keep], b[k][keep]), k
        changed |= not torch.equal(v[2], b[k][2])
    assert changed and not torch.equal(got.physics.q[2], before.physics.q[2])


def test_masked_reset_equals_jax(masked):
    _, got, want = masked
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k, v in g.items():
        np.testing.assert_allclose(v.double().numpy(), w[k].double().numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- CLI and harness
CLI_ARGS = ["device=cpu", "task=BlindGrasping", "numEnvs=4", "env.episodeLength=6",
            "sim.substeps=1", "sim.physics_steps_per_control=1",
            "train.logging.noLogFile=true", "train.params.network.units=[32,32]",
            "env.video.resolution=[160,120]"]
KEYS = ("Enter", "ArrowUp", "e", "%20")


def test_cli_evaluation_drives_the_sidecar(tmp_path, monkeypatch):
    """test=true with env.videoRecord, env.videoStream and env.viewer: the
    keys go through /control after the second frame, the E key resets the
    selected env, the mp4 and /stats count the frames, and the termination
    reasons are logged."""
    monkeypatch.setenv("DEXHAND_RUNS_DIR", str(tmp_path))
    s = cli.build(load_config(CLI_ARGS + [
        "test=true", "testGamesNum=12", "env.videoRecord=true", "env.videoStream=true",
        "env.viewer=true", "env.stream.port=18460"]))
    after, sent = cli.Sidecar.after_step, []

    def after_step(sc, state, games):
        after(sc, state, games)
        if sc.frames == 2:
            for k in KEYS:
                _get(f"http://127.0.0.1:{sc.streamer.port}/control?key={k}")
                sent.append(k)
            sent.append(sc.streamer.stats()["keys_received"])

    monkeypatch.setattr(cli.Sidecar, "after_step", after_step)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    s.logger.addHandler(handler)
    try:
        assert cli.run_test(s) == 0
    finally:
        s.logger.removeHandler(handler)
    st = s.stats[-1]
    sc = st["sidecar"]
    assert sent[-1] == 4 and st["episodes"] >= 12
    assert (sc["view_mode"], sc["selected_env"], sc["random_actions"], sc["resets"]) == (
        1, 1, True, [1])
    assert sc["frames"] == sc["stream"]["frames_received"] > 2
    videos = os.path.join(s.run_dir, "videos")
    assert os.listdir(videos) == ["episode_00001.mp4"]
    assert os.path.getsize(os.path.join(videos, "episode_00001.mp4")) > 1000
    assert "Viewer: reset env 1" in lines and "Random actions: True" in lines
    assert any(x.startswith("Termination reasons: ") for x in lines)
    assert sum(st["reasons"].values()) <= st["episodes"]
    assert any(k.startswith("failure_reason_") for k in st["reasons"])
