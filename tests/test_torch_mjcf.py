"""The port's MJCF loader and the env on `env.handAsset`, held against the
JAX package (CPU), on both hand files of the repository: the vendored
`dexrobot_isaac_tpu/assets/dexhand021_right_simplified_floating.xml` and
`tests/fixtures/dexhand021_upstream_format.xml` (the upstream layout:
default classes, visual meshes, fullinertia).

(a) `models/mjcf.py` `load_mjcf` gives the JAX loader's arrays exactly
    (the same numpy code on the same float64 input).
(b) BlindGrasping on `env.handAsset` (8 envs, 2 substeps, episodeLength 3
    so an auto-reset fires), 4 steps with the JAX step's reset samples: the
    port's unfused step from its own reset and from the JAX state carried
    over, and its plain fused step from the JAX state, against the JAX env
    on the same asset. Obs atol 2e-4, reward and components atol 1e-3,
    done exact (tests/test_golden_trajectory.py). The MJCF model orders its
    collision spheres differently from the built-in model, so the engine's
    pruned finger pairs differ in order too; the plain fused step equals
    the unfused step bit for bit on it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dexrobot_isaac_tpu.models.mjcf import load_mjcf as jax_load_mjcf
from dexrobot_isaac_tpu_torch import convert
from dexrobot_isaac_tpu_torch.factory import make_env
from dexrobot_isaac_tpu_torch.models.dexhand021 import HandModel, build_hand_model
from dexrobot_isaac_tpu_torch.models.mjcf import load_mjcf
from dexrobot_isaac_tpu_torch.utils.config import load_config
from tests import torch_parity as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XMLS = {"vendored": os.path.join(REPO, "dexrobot_isaac_tpu", "assets",
                                 "dexhand021_right_simplified_floating.xml"),
        "upstream": os.path.join(REPO, "tests", "fixtures", "dexhand021_upstream_format.xml")}
FIELDS = [f.name for f in dataclasses.fields(HandModel)]
STEPS = 4


@pytest.fixture(scope="module", params=list(XMLS))
def models(request):
    xml = XMLS[request.param]
    return load_mjcf(xml), jax_load_mjcf(xml)


@pytest.mark.parametrize("field", FIELDS)
def test_loader_arrays_equal_jax(models, field):
    got, want = models
    g, w = getattr(got, field), getattr(want, field)
    if field == "visual_geoms":
        tp.assert_visual_geoms_equal(g, w)
    elif isinstance(g, list):
        assert g == list(w)
    else:
        assert g.dtype == np.asarray(w).dtype and g.shape == np.asarray(w).shape
        np.testing.assert_array_equal(g, w)


def test_loaded_model_differs_from_builtin_in_sphere_order_only(models):
    """The loaded model is the built-in one up to the order of its
    collision spheres (tests/test_mjcf_model.py compares them sorted)."""
    got, _ = models
    ref = build_hand_model()
    assert got.body_names == ref.body_names and got.site_names == ref.site_names
    key = lambda m: np.lexsort((m.sphere_pos[:, 2], m.sphere_pos[:, 1], m.sphere_pos[:, 0],
                                m.sphere_body))
    np.testing.assert_array_equal(got.sphere_body[key(got)], ref.sphere_body[key(ref)])
    np.testing.assert_allclose(got.sphere_pos[key(got)], ref.sphere_pos[key(ref)], atol=1e-12)


def _config(xml):
    return ["task=BlindGrasping", "numEnvs=8", "env.episodeLength=3", "sim.substeps=1",
            "sim.physics_steps_per_control=2", f"env.handAsset={xml}"]


@pytest.fixture(scope="module", params=list(XMLS))
def asset_runs(request):
    xml = XMLS[request.param]
    config = _config(xml)
    run = tp.jax_rollout(config, 5, STEPS)
    env = make_env(load_config(config), seed=5, device="cpu")
    fused = env.make_fused()
    fused_out = []
    for t in range(STEPS):
        sample, dr = tp.samples_at(run, t)
        rst, drn = fused.operand_rows(sample, dr, env.num_envs, "cpu")
        state = convert.env_state(run["states"][t], "cpu")
        _, obs, rew, done, ex = fused.step_fn(fused.pack(state), tp.T(run["actions"][t]),
                                              operands=(rst, drn))
        fused_out.append((obs.numpy(), rew.numpy(), done.numpy(), ex))
    return xml, env, run, tp.port_runs(env, run), fused_out


def test_env_uses_the_loaded_model(asset_runs):
    xml, env, _, _, _ = asset_runs
    np.testing.assert_array_equal(env.comps.model.sphere_pos, load_mjcf(xml).sphere_pos)
    assert not np.array_equal(env.comps.model.sphere_pos, build_hand_model().sphere_pos)


def test_reset_obs_matches_jax(asset_runs):
    _, _, run, port, _ = asset_runs
    np.testing.assert_allclose(port["reset_obs"], run["reset_obs"], rtol=0, atol=2e-4)


@pytest.mark.parametrize("start", ["own", "carried"])
@pytest.mark.parametrize("t", range(STEPS))
def test_unfused_step_matches_jax(asset_runs, start, t):
    _, _, run, port, _ = asset_runs
    tp.assert_step_matches(port[start], run, t)


@pytest.mark.parametrize("t", range(STEPS))
def test_plain_fused_step_matches_jax(asset_runs, t):
    _, _, run, _, fused_out = asset_runs
    obs, rew, done, ex = fused_out[t]
    np.testing.assert_array_equal(done, run["done"][t])
    np.testing.assert_allclose(obs, run["obs"][t], rtol=0, atol=2e-4)
    np.testing.assert_allclose(rew, run["rew"][t], rtol=0, atol=1e-3)


def test_plain_fused_step_equals_unfused(asset_runs):
    _, env, run, _, _ = asset_runs
    assert torch.is_tensor(tp.assert_fused_equals_unfused(env, run, t=2))
