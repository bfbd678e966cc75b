"""Checkpoint save/load + hot-reload monitoring (torch): the port of
`dexrobot_isaac_tpu/rl/checkpoint.py`.

The port's own format, one `torch.save` dict: the params, the optimizer
state, both running stats, lr, epoch, the learner's generator state and the
meta dict (iteration, curriculum difficulty, ...). Files are written to a
temporary name and renamed, so a hot-reloading reader never sees a partial
file. Loading reads tensors only (`weights_only=True`). Reading the JAX
package's flax msgpack `.ckpt` files is not supported.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable, Dict, Optional

import torch

from dexrobot_isaac_tpu_torch.rl.ppo import AdamState, PPOLearner, PPOState
from dexrobot_isaac_tpu_torch.rl.running_stats import RunningMeanStd
from dexrobot_isaac_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def save_checkpoint(path: str, ppo_state: PPOState, meta: Optional[Dict] = None,
                    learner: Optional[PPOLearner] = None) -> None:
    """`learner`, when given, adds its generator state."""
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    opt = ppo_state.opt_state
    payload = {
        "params": cpu(ppo_state.params),
        "opt_state": {"count": opt.count.cpu(), "mu": cpu(opt.mu), "nu": cpu(opt.nu)},
        "obs_rms": cpu(ppo_state.obs_rms.to_dict()),
        "value_rms": cpu(ppo_state.value_rms.to_dict()),
        "lr": ppo_state.lr.cpu(),
        "epoch": ppo_state.epoch.cpu(),
        "generator": None if learner is None else learner.generator.get_state(),
        "meta": dict(meta or {}),
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _read(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, ppo_state: PPOState,
                    learner: Optional[PPOLearner] = None) -> PPOState:
    """The saved state on `ppo_state`'s device (tensor by tensor, raising on
    a missing or mismatched parameter); with `learner`, its generator
    continues from the saved state."""
    data = _read(path)
    dev = ppo_state.lr.device
    on = lambda d: {k: v.to(dev) for k, v in d.items()}
    if set(data["params"]) != set(ppo_state.params):
        raise ValueError(f"{path}: parameters {sorted(data['params'])} do not match the "
                         f"network's {sorted(ppo_state.params)}")
    for k, v in data["params"].items():
        if v.shape != ppo_state.params[k].shape:
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the network "
                             f"{tuple(ppo_state.params[k].shape)}")
    if learner is not None and data.get("generator") is not None:
        learner.generator.set_state(data["generator"])
    o = data["opt_state"]
    return dataclasses.replace(
        ppo_state,
        params=on(data["params"]),
        opt_state=AdamState(o["count"].to(dev), on(o["mu"]), on(o["nu"])),
        obs_rms=RunningMeanStd(**on(data["obs_rms"])),
        value_rms=RunningMeanStd(**on(data["value_rms"])),
        lr=data["lr"].to(dev),
        epoch=data["epoch"].to(dev),
    )


def load_checkpoint_meta(path: str) -> Dict[str, Any]:
    """Only the meta dict (iteration, reward, curriculum difficulty, ...):
    a resumed run continues the host-side controller state from it."""
    return dict(_read(path).get("meta") or {})


class HotReloadMonitor:
    """Background thread polling a checkpoint file's mtime; calls
    `on_reload(path)` when it changes (rl_games_patches.py:21-181)."""

    def __init__(self, checkpoint_path: str, on_reload: Callable[[str], None],
                 interval_seconds: float = 30.0):
        self.path = checkpoint_path
        self.on_reload = on_reload
        self.interval = interval_seconds
        self._stop = threading.Event()
        self._last_mtime = self._mtime()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _mtime(self) -> float:
        try:
            return os.stat(self.path).st_mtime
        except OSError:
            return -1.0

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            m = self._mtime()
            if m > self._last_mtime:
                self._last_mtime = m
                logger.info(f"Hot-reload: new checkpoint detected at {self.path}")
                try:
                    self.on_reload(self.path)
                except Exception as e:  # keep monitoring; a reload is best-effort
                    logger.warning(f"Hot-reload failed: {e}")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=self.interval + 5.0)
