"""Checkpoint save/load + hot-reload monitoring (torch): the port of
`dexrobot_isaac_tpu/rl/checkpoint.py`.

The port's own format, one `torch.save` dict: the params, the optimizer
state, both running stats, lr, epoch, the learner's generator state and the
meta dict (iteration, curriculum difficulty, ...). Files are written to a
temporary name and renamed, so a hot-reloading reader never sees a partial
file. Loading reads tensors only (`weights_only=True`).

`load_checkpoint` and `load_checkpoint_meta` also read the JAX package's
`.ckpt` files (`flax.serialization.to_bytes` of params, both running stats,
lr, epoch and meta: msgpack, decoded by utils/msgpack_read.py without flax
or msgpack). They tell the two formats apart by content: a `torch.save` zip
or a msgpack map. A JAX file carries no optimizer state and no generator,
so loading one keeps the template's, as the JAX `load_checkpoint` keeps its
optimizer state; its flax params become the port's through
`convert.actor_critic_from_flax`. So `train.py test=true checkpoint=<a JAX
.ckpt>` evaluates a policy trained by the JAX package.
"""

from __future__ import annotations

import dataclasses
import io
import os
import threading
from typing import Any, Callable, Dict, Optional

import torch

from dexrobot_isaac_tpu_torch.convert import actor_critic_from_flax
from dexrobot_isaac_tpu_torch.rl.ppo import AdamState, PPOLearner, PPOState
from dexrobot_isaac_tpu_torch.rl.running_stats import RunningMeanStd
from dexrobot_isaac_tpu_torch.utils import msgpack_read
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


def read_payload(path: str) -> Dict[str, Any]:
    """The payload of either format, as the port's dict of CPU tensors (a
    JAX file without opt_state and generator)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"PK\x03\x04":  # torch.save writes a zip archive
        return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
    tree = msgpack_read.unpackb(data)
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path}: neither a torch.save checkpoint nor a JAX package .ckpt")
    return _from_flax(tree)


def _from_flax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A decoded JAX payload (rl/checkpoint.py:31-44 of the JAX package)."""
    t = lambda x: torch.as_tensor(x)
    return {"params": actor_critic_from_flax(tree["params"], device="cpu"),
            "obs_rms": {k: t(v) for k, v in tree["obs_rms"].items()},
            "value_rms": {k: t(v) for k, v in tree["value_rms"].items()},
            "lr": t(tree["lr"]), "epoch": t(tree["epoch"]), "meta": tree.get("meta") or {}}


def load_checkpoint(path: str, ppo_state: PPOState,
                    learner: Optional[PPOLearner] = None) -> PPOState:
    """The saved state on `ppo_state`'s device (tensor by tensor, raising on
    a missing or mismatched parameter); with `learner`, its generator
    continues from the saved state (rank 0's; `set_generator_state`). A JAX
    package `.ckpt` keeps `ppo_state`'s optimizer state and the learner's
    generator."""
    data = read_payload(path)
    dev = ppo_state.lr.device
    on = lambda d: {k: v.to(dev) for k, v in d.items()}
    like = lambda v, ref: v.to(device=dev, dtype=ref.dtype)
    if set(data["params"]) != set(ppo_state.params):
        raise ValueError(f"{path}: parameters {sorted(data['params'])} do not match the "
                         f"network's {sorted(ppo_state.params)}")
    for k, v in data["params"].items():
        if v.shape != ppo_state.params[k].shape:
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the network "
                             f"{tuple(ppo_state.params[k].shape)}")
    if learner is not None and data.get("generator") is not None:
        learner.set_generator_state(data["generator"], int(data["epoch"]))
    o = data.get("opt_state")
    rms = lambda d, ref: RunningMeanStd(**{k: like(v, getattr(ref, k)) for k, v in d.items()})
    return dataclasses.replace(
        ppo_state,
        params=on(data["params"]),
        opt_state=ppo_state.opt_state if o is None
        else AdamState(o["count"].to(dev), on(o["mu"]), on(o["nu"])),
        obs_rms=rms(data["obs_rms"], ppo_state.obs_rms),
        value_rms=rms(data["value_rms"], ppo_state.value_rms),
        lr=like(data["lr"], ppo_state.lr),
        epoch=like(data["epoch"], ppo_state.epoch),
    )


def load_checkpoint_meta(path: str) -> Dict[str, Any]:
    """Only the meta dict (iteration, reward, curriculum difficulty, ...) of
    either format: a resumed run continues the host-side controller state
    from it."""
    return dict(read_payload(path).get("meta") or {})


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
