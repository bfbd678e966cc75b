"""Carry the JAX package's data over into the port (numpy in, torch out).

The JAX package's states, samples and model arrive here as numpy (a caller
runs `jax.device_get` first); this module imports nothing of JAX and reads
them by attribute name, so both packages compute on the same values:

- `env_state`: a JAX `EnvState` -> the port's `EnvState` (its `rng` key has
  no counterpart: the port's env owns a torch.Generator), the second box's
  leaves included where the scene has one;
- `fused_state`: a JAX `FusedEnvState` -> the port's `FusedEnvState`;
- `task_reset` / `dr_sample`: JAX reset and DR samples -> the port's, which
  `envs/fused_step.py` `operand_rows` turns into the kernel's operand rows;
- `hand_model`: the JAX `HandModel` arrays -> the port's `HandModel`;
- `actor_critic_from_flax`: flax `ActorCritic` params -> the port's
  `ActorCritic` params (`PPOState.params`);
- `running_mean_std`: a JAX `RunningMeanStd` -> the port's.

`rl/checkpoint.py` reads the JAX package's `.ckpt` files (flax msgpack)
itself and carries their params over through `actor_critic_from_flax`.

The tensors go to the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.envs.fused_step import FusedEnvState
from dexrobot_isaac_tpu_torch.envs.tasks.api import TaskReset
from dexrobot_isaac_tpu_torch.envs.types import EnvState
from dexrobot_isaac_tpu_torch.models.dexhand021 import HandModel
from dexrobot_isaac_tpu_torch.physics.types import DRSample, PhysicsState
from dexrobot_isaac_tpu_torch.rl.running_stats import RunningMeanStd
from dexrobot_isaac_tpu_torch.utils.device import resolve_device


def tensor(x, device="cuda") -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=resolve_device(device))


def _opt(x, device):
    """A tensor of x, or None for a leaf the JAX state leaves out (the
    second box of a single-box scene)."""
    return None if x is None else tensor(x, device)


def _fields(cls, src, device, names=None):
    return {f.name: _opt(getattr(src, f.name), device)
            for f in dataclasses.fields(cls) if names is None or f.name in names}


def dr_sample(src, device="cuda") -> DRSample:
    return DRSample(**_fields(DRSample, src, device))


def env_state(src, device="cuda") -> EnvState:
    flat = {f.name for f in dataclasses.fields(EnvState)} - {
        "physics", "success_flags", "failure_flags", "task_states", "dr"}
    d = lambda m: {k: tensor(v, device) for k, v in m.items()}
    return EnvState(
        physics=PhysicsState(**_fields(PhysicsState, src.physics, device)),
        success_flags=d(src.success_flags), failure_flags=d(src.failure_flags),
        task_states=d(src.task_states), dr=dr_sample(src.dr, device),
        **_fields(EnvState, src, device, flat),
    )


def fused_state(src, device="cuda") -> FusedEnvState:
    return FusedEnvState(**_fields(FusedEnvState, src, device))


def task_reset(src, device="cuda") -> TaskReset:
    return TaskReset(
        dof_pos=tensor(src.dof_pos, device), box_pos=_opt(src.box_pos, device),
        box_quat=_opt(src.box_quat, device),
        task_states=None if src.task_states is None
        else {k: tensor(v, device) for k, v in src.task_states.items()},
        box2_pos=_opt(src.box2_pos, device), box2_quat=_opt(src.box2_quat, device),
    )


def hand_model(src) -> HandModel:
    return HandModel(**{f.name: (list(getattr(src, f.name)) if f.type.startswith("List[")
                                 else np.array(getattr(src, f.name)))
                        for f in dataclasses.fields(HandModel)})


def actor_critic_from_flax(params_np, device="cuda") -> dict:
    """flax params of `ActorCritic` (the tree `network.init` returns, or its
    "params" entry, as numpy) -> {name: tensor} in the port's
    `ActorCritic.named_parameters()` naming. A Dense kernel (in, out)
    becomes a torch weight (out, in)."""
    tree = params_np.get("params", params_np)
    out = {}
    for name, leaf in tree.items():
        if name == "log_std":
            out["log_std"] = tensor(leaf, device)
            continue
        out[f"layers.{name}.weight"] = tensor(np.asarray(leaf["kernel"]).T, device)
        out[f"layers.{name}.bias"] = tensor(leaf["bias"], device)
    return out


def running_mean_std(src, device="cuda") -> RunningMeanStd:
    return RunningMeanStd(tensor(src.mean, device), tensor(src.var, device),
                          tensor(src.count, device))
