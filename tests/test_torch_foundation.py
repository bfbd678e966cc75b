"""Foundation of the torch port held against the JAX package (CPU).

The hand model arrays, the constants, the quaternion ops (seeded random
inputs, atol 1e-6), `load_config` for every task and experiment overlay,
the JSON copy of the cfg tree against its YAML twin, and the CLI scalar
parser against yaml.safe_load.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from dexrobot_isaac_tpu import constants as jc
from dexrobot_isaac_tpu.models.dexhand021 import build_hand_model as jax_model
from dexrobot_isaac_tpu.ops import quat as jq
from dexrobot_isaac_tpu.utils import config as jcfg
from dexrobot_isaac_tpu_torch import constants as tc
from dexrobot_isaac_tpu_torch import convert
from dexrobot_isaac_tpu_torch.models.dexhand021 import HandModel
from dexrobot_isaac_tpu_torch.models.dexhand021 import build_hand_model as torch_model
from dexrobot_isaac_tpu_torch.ops import quat as tq
from dexrobot_isaac_tpu_torch.utils import config as tcfg
from tests.torch_parity import assert_visual_geoms_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_DIR = os.path.join(REPO, "dexrobot_isaac_tpu", "cfg")
JSON_DIR = os.path.join(REPO, "dexrobot_isaac_tpu_torch", "cfg")


def _assert_model_equal(a, b):
    for f in dataclasses.fields(HandModel):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "visual_geoms":
            assert_visual_geoms_equal(x, y)
        elif isinstance(x, list):
            assert x == y, f.name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name


def test_hand_model_arrays_equal():
    _assert_model_equal(jax_model(), torch_model())


def test_converted_hand_model_equals_port_model():
    _assert_model_equal(convert.hand_model(jax_model()), torch_model())


def test_constants_equal():
    names = [n for n in dir(jc) if n.isupper()]
    assert names == [n for n in dir(tc) if n.isupper()]
    for n in names:
        assert getattr(jc, n) == getattr(tc, n), n


# ---------------------------------------------------------------- quat ops
def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


QUAT_CASES = {
    "quat_mul": lambda m, a, b, v, s: m.quat_mul(a, b),
    "quat_rotate": lambda m, a, b, v, s: m.quat_rotate(a, v),
    "quat_rotate_inverse": lambda m, a, b, v, s: m.quat_rotate_inverse(a, v),
    "quat_conjugate": lambda m, a, b, v, s: m.quat_conjugate(a),
    "quat_unit": lambda m, a, b, v, s: m.quat_unit(b * 3.0),
    "quat_from_axis_angle": lambda m, a, b, v, s: m.quat_from_axis_angle(v, s),
    "quat_to_rotmat": lambda m, a, b, v, s: m.quat_to_rotmat(a),
    "quat_integrate": lambda m, a, b, v, s: m.quat_integrate(a, v, 0.0025),
    "point_in_hand_frame": lambda m, a, b, v, s: m.point_in_hand_frame(v, b[..., :3], a),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quat_op_matches_jax(name):
    n = 64
    a = _unit(_rand((n, 4), 1))
    b = _rand((n, 4), 2)
    v = _rand((n, 3), 3)
    s = _rand((n,), 4)
    fn = QUAT_CASES[name]
    want = np.asarray(fn(jq, *(jnp.asarray(x) for x in (a, b, v, s))))
    got = fn(tq, *(torch.as_tensor(x) for x in (a, b, v, s))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- config
def _names(group):
    return sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(YAML_DIR, group, "*.yaml")))


@pytest.mark.parametrize(
    "overrides",
    [[]] + [[f"task={t}"] for t in _names("task")]
    + [[f"experiments={e}"] for e in _names("experiments")]
    + [["task=BlindGrasping", "numEnvs=4096", "sim.substeps=2", "env.episodeLength=6",
        "train.seed=7", "sim.contact.stiffness=9000.5", "headless=true"]],
    ids=lambda o: " ".join(o) or "defaults",
)
def test_load_config_matches_jax(overrides):
    assert tcfg.load_config(list(overrides)) == jcfg.load_config(list(overrides))


def _yaml_files():
    return sorted(os.path.relpath(p, YAML_DIR)
                  for p in glob.glob(os.path.join(YAML_DIR, "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("rel", _yaml_files())
def test_json_cfg_equals_yaml_twin(rel):
    with open(os.path.join(YAML_DIR, rel)) as f:
        want = yaml.safe_load(f) or {}
    with open(os.path.join(JSON_DIR, rel[:-5] + ".json")) as f:
        assert json.load(f) == want


def test_json_cfg_tree_has_no_extra_files():
    got = sorted(os.path.relpath(p, JSON_DIR)[:-5]
                 for p in glob.glob(os.path.join(JSON_DIR, "**", "*.json"), recursive=True))
    assert got == [r[:-5] for r in _yaml_files()]


@pytest.mark.parametrize("text", [
    "1", "-3", "0", "1.5", "1e-3", "1.0e-3", ".5", "true", "False", "yes", "off", "null",
    "~", "abc", "tpu", "[1, 2]", ".inf", "-.inf", "'quoted'", "1_000",
    "[object_pos, object_vel, grasp_state]", "[a, 1.5, true, null]", "[]",
])
def test_cli_value_parse_matches_yaml(text):
    want = yaml.safe_load(text)
    got = tcfg.parse_value(text)
    assert got == want and type(got) is type(want)


def test_get_by_path_and_errors():
    cfg = tcfg.load_config(["task=BlindGrasping"])
    assert tcfg.get_by_path(cfg, "task.box.size") == 0.05
    assert tcfg.get_by_path(cfg, "task.nope.x", 3) == 3
    with pytest.raises(ValueError):
        tcfg.load_config(["tarin.seed=1"])
    with pytest.raises(ValueError):
        tcfg.load_config(["numEnvs"])
