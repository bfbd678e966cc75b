"""Reward-component observer (torch): the port of
`dexrobot_isaac_tpu/rl/observer.py`.

Per-episode reward breakdowns split by termination type, logged as

    reward_breakdown/<all|success|failure|timeout>/<raw|weighted>/<episode|step>/<name>

plus `training/termination_rates/*` and `training/episode_length`.

- `RewardComponentObserver` (host numpy, the JAX package's code copied):
  `process_rollout` over full (T, N) extras, and `process_device_window`
  over a `DeviceBreakdown` window summary.
- `DeviceBreakdown`: per-env episode accumulators and per-(termination
  type, component) window totals kept on the device; each iteration's
  extras fold in without a host transfer, and the host fetches only the
  window totals (a few hundred scalars) per logging window. With a process
  group the window totals are summed over the ranks before the host reads
  them, so every rank sees the global breakdown (JAX builds it from the
  global extras, train.py:404-454) and the curriculum promotes alike.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, Optional

import numpy as np
import torch

from dexrobot_isaac_tpu_torch.parallel.mesh import Group

_TYPES = ("success", "failure", "timeout")


class RewardComponentObserver:
    def __init__(self, writer=None, log_interval: int = 100):
        self.writer = writer
        self.log_interval = log_interval
        self._acc: Dict[str, np.ndarray] = {}       # per-env running episode sums
        self._steps: Optional[np.ndarray] = None    # per-env episode step counts
        self._finished = defaultdict(list)          # (type, name) -> per-episode sums
        self._finished_steps = defaultdict(list)
        self._episodes_since_log = 0
        self._term_counts = defaultdict(int)
        self._global_step = 0

    def process_rollout(self, extras: Dict[str, np.ndarray]) -> None:
        """Consume stacked rollout extras: arrays shaped (T, N)."""
        comps = {
            k: np.asarray(v) for k, v in extras["reward_components"].items()
        }
        success = np.asarray(extras["success"])
        failure = np.asarray(extras["failure"])
        timeout = np.asarray(extras["timeout"])
        T, N = success.shape

        if self._steps is None:
            self._steps = np.zeros(N, dtype=np.int64)
            for k in comps:
                self._acc[k] = np.zeros(N, dtype=np.float64)
        for k in comps:
            if k not in self._acc:
                self._acc[k] = np.zeros(N, dtype=np.float64)

        for t in range(T):
            self._global_step += N
            for k, v in comps.items():
                self._acc[k] += v[t]
            self._steps += 1
            done = success[t] | failure[t] | timeout[t]
            if done.any():
                idx = np.nonzero(done)[0]
                types = np.where(
                    success[t, idx], "success",
                    np.where(failure[t, idx], "failure", "timeout"),
                )
                for j, env in enumerate(idx):
                    ttype = str(types[j])
                    self._term_counts[ttype] += 1
                    for k in comps:
                        self._finished[(ttype, k)].append(self._acc[k][env])
                        self._finished[("all", k)].append(self._acc[k][env])
                    self._finished_steps[ttype].append(self._steps[env])
                    self._finished_steps["all"].append(self._steps[env])
                for k in comps:
                    self._acc[k][idx] = 0.0
                self._steps[idx] = 0
                self._episodes_since_log += len(idx)

        if self._episodes_since_log >= self.log_interval:
            self._flush()

    def _flush(self) -> None:
        if self.writer is None:
            self._reset_window()
            return
        total = sum(self._term_counts.values())
        for ttype in ("all", "success", "failure", "timeout"):
            steps = self._finished_steps.get(ttype)
            if not steps:
                continue
            mean_len = float(np.mean(steps))
            for (tt, name), sums in list(self._finished.items()):
                if tt != ttype or not sums:
                    continue
                kind = "weighted" if name.endswith("_weighted") else "raw"
                base = name[:-9] if name.endswith("_weighted") else name
                ep_mean = float(np.mean(sums))
                self.writer.add_scalar(
                    f"reward_breakdown/{ttype}/{kind}/episode/{base}",
                    ep_mean, self._global_step,
                )
                self.writer.add_scalar(
                    f"reward_breakdown/{ttype}/{kind}/step/{base}",
                    ep_mean / max(mean_len, 1.0), self._global_step,
                )
        if total > 0:
            for ttype in ("success", "failure", "timeout"):
                self.writer.add_scalar(
                    f"training/termination_rates/{ttype}",
                    self._term_counts[ttype] / total, self._global_step,
                )
            self.writer.add_scalar(
                "training/episode_length",
                float(np.mean(self._finished_steps["all"])), self._global_step,
            )
        self._reset_window()

    def _reset_window(self) -> None:
        self._finished.clear()
        self._finished_steps.clear()
        self._term_counts.clear()
        self._episodes_since_log = 0

    # ------------------------------------------------------------------
    # device-side windowed path
    # ------------------------------------------------------------------
    def process_device_window(self, summary: Dict[str, Any]) -> None:
        """Emit the same TB keys from a fetched DeviceBreakdown window summary
        (`DeviceBreakdown.fetch_and_reset`)."""
        self._global_step = int(summary["global_step"])
        counts = np.asarray(summary["ep_count"], dtype=np.float64)   # (3,)
        step_sum = np.asarray(summary["step_sum"], dtype=np.float64)  # (3,)
        comp_sum = {
            k: np.asarray(v, dtype=np.float64)
            for k, v in summary["comp_sum"].items()
        }
        total = float(counts.sum())
        if self.writer is None or total == 0:
            return
        for ti, ttype in enumerate(("all",) + _TYPES):
            if ttype == "all":
                cnt, ssum = total, float(step_sum.sum())
                csel = {k: float(v.sum()) for k, v in comp_sum.items()}
            else:
                cnt, ssum = float(counts[ti - 1]), float(step_sum[ti - 1])
                csel = {k: float(v[ti - 1]) for k, v in comp_sum.items()}
            if cnt == 0:
                continue
            mean_len = ssum / cnt
            for name, csum in csel.items():
                kind = "weighted" if name.endswith("_weighted") else "raw"
                base = name[:-9] if name.endswith("_weighted") else name
                ep_mean = csum / cnt
                self.writer.add_scalar(
                    f"reward_breakdown/{ttype}/{kind}/episode/{base}",
                    ep_mean, self._global_step,
                )
                self.writer.add_scalar(
                    f"reward_breakdown/{ttype}/{kind}/step/{base}",
                    ep_mean / max(mean_len, 1.0), self._global_step,
                )
        for ti, ttype in enumerate(_TYPES):
            self.writer.add_scalar(
                f"training/termination_rates/{ttype}",
                float(counts[ti]) / total, self._global_step,
            )
        self.writer.add_scalar(
            "training/episode_length", float(step_sum.sum()) / total,
            self._global_step,
        )


@dataclasses.dataclass
class DeviceBreakdown:
    """Device-resident reward-breakdown reducer (tensors on the extras'
    device; `update` runs on the device, `fetch_and_reset` syncs)."""

    state: Dict[str, torch.Tensor]
    comp_names: tuple
    group: Optional[Group] = None   # sums the window totals over its ranks

    @classmethod
    def create(cls, roll_extras, comp_names=None, group: Optional[Group] = None
               ) -> "DeviceBreakdown":
        """`roll_extras` carries either the reward-component dict or the
        packed `reward_components_packed` (T, N, C) (the learner's slim
        extras); in the packed case `comp_names` gives the packing order.
        With `group`, the fetched window is the sum over its ranks."""
        if "reward_components_packed" in roll_extras:
            packed = roll_extras["reward_components_packed"]
            if comp_names is None:
                raise ValueError("packed rollout extras require comp_names (the static "
                                 "packing order, e.g. PPOLearner.comp_names)")
            comp_names = tuple(comp_names)
            n, c, dev = packed.shape[1], packed.shape[2], packed.device
            if c != len(comp_names):
                raise ValueError(f"comp_names has {len(comp_names)} entries but packed "
                                 f"extras carry {c} components")
        else:
            comps = roll_extras["reward_components"]
            comp_names = tuple(sorted(comps))
            n, c = comps[comp_names[0]].shape[1], len(comp_names)
            dev = comps[comp_names[0]].device
        z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device=dev)
        state = {
            "comp_acc": z(n, c), "step_acc": z(n, dt=torch.int32),
            "ep_count": z(3, dt=torch.int32), "step_sum": z(3), "comp_sum": z(3, c),
            # strict-spawn [successes, dones] of tasks reporting
            # spawn_difficulty (train.py promote_strict); zero otherwise
            "ep_count_strict": z(2, dt=torch.int32),
        }
        return cls(state=state, comp_names=comp_names, group=group)

    def update(self, extras) -> None:
        st = self.state
        if "reward_components_packed" in extras:
            comp_t = extras["reward_components_packed"]                     # (T, N, C)
        else:
            comp_t = torch.stack([extras["reward_components"][k] for k in self.comp_names], -1)
        masks = torch.stack([extras["success"], extras["failure"], extras["timeout"]], -1)
        comp_acc, step_acc = st["comp_acc"], st["step_acc"]
        ep_count, step_sum, comp_sum = st["ep_count"], st["step_sum"], st["comp_sum"]
        for t in range(comp_t.shape[0]):
            comp_acc = comp_acc + comp_t[t]
            step_acc = step_acc + 1
            mt = masks[t]                                                   # (N, 3)
            done = mt.any(-1)
            mf = mt.float()
            ep_count = ep_count + mt.sum(0, dtype=torch.int32)
            step_sum = step_sum + (mf * step_acc[:, None]).sum(0)
            comp_sum = comp_sum + torch.einsum("nt,nc->tc", mf, comp_acc)
            comp_acc = torch.where(done[:, None], torch.zeros_like(comp_acc), comp_acc)
            step_acc = torch.where(done, torch.zeros_like(step_acc), step_acc)
        ep_strict = st["ep_count_strict"]
        if "success_strict" in extras and "done_strict" in extras:
            ep_strict = ep_strict + torch.stack([extras["success_strict"].sum(),
                                                 extras["done_strict"].sum()]).to(torch.int32)
        self.state = {"comp_acc": comp_acc, "step_acc": step_acc, "ep_count": ep_count,
                      "step_sum": step_sum, "comp_sum": comp_sum, "ep_count_strict": ep_strict}

    def fetch_and_reset(self, global_step: int = 0) -> Dict[str, Any]:
        """Fetch the window totals, summed over the group's ranks, to the host
        and zero them (the per-env episode accumulators carry over).
        `global_step` is stamped into the summary."""
        keys = ("ep_count", "step_sum", "comp_sum", "ep_count_strict")
        window = {k: self.state[k] for k in keys}
        if self.group is not None:
            window = self.group.all_reduce_sum(window)
        host = {k: v.cpu().numpy() for k, v in window.items()}
        host["global_step"] = int(global_step)
        comp_sum = host["comp_sum"]
        host["comp_sum"] = {k: comp_sum[:, i] for i, k in enumerate(self.comp_names)}
        self.state = {**self.state, **{k: torch.zeros_like(self.state[k]) for k in keys}}
        return host
