"""Termination: success / failure / timeout masks + one-time rewards (torch).

The port's counterpart of `dexrobot_isaac_tpu/envs/termination.py`,
including the builtin `hitting_ground` criterion.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class TerminationConfig:
    active_success_criteria: Tuple[str, ...]
    active_failure_criteria: Tuple[str, ...]
    max_episode_length: int
    success_reward: float
    failure_penalty: float
    timeout_penalty: float
    handbase_threshold: float = 0.0
    fingertip_threshold: float = 0.0
    has_height_safety: bool = True
    max_consecutive_successes: int = 50

    def validate(self, success_names, failure_names):
        for name in self.active_success_criteria:
            if name not in success_names:
                raise RuntimeError(f"Success criterion '{name}' is active but not "
                                   f"implemented (available: {sorted(success_names)})")
        for name in self.active_failure_criteria:
            if name not in failure_names:
                raise RuntimeError(f"Failure criterion '{name}' is active but not "
                                   f"implemented (available: {sorted(failure_names)})")

    def active_success(self, names):
        return sorted(k for k in names if not self.active_success_criteria
                      or k in self.active_success_criteria)

    def active_failure(self, names):
        return sorted(k for k in names if not self.active_failure_criteria
                      or k in self.active_failure_criteria)


def builtin_failure_criteria(cfg: TerminationConfig, obs_dict) -> Dict[str, torch.Tensor]:
    """`hitting_ground`: hand base or any fingertip below threshold (only
    when the task configures height_safety)."""
    if not cfg.has_height_safety:
        return {}
    n = obs_dict["hand_pose"].shape[0]
    min_tip = obs_dict["fingertip_poses_world"].reshape(n, 5, 7)[:, :, 2].amin(dim=1)
    return {"hitting_ground": (obs_dict["hand_pose"][:, 2] < cfg.handbase_threshold)
            | (min_tip < cfg.fingertip_threshold)}


def evaluate_termination(cfg: TerminationConfig, episode_step_count, success_criteria,
                         failure_criteria, success_flags, failure_flags):
    """Returns (should_reset, info, termination_reward, term_components,
    new_success_flags, new_failure_flags). `info` holds the success,
    failure and timeout masks, their rates, each active criterion's mean
    (`success_<name>`, `failure_<name>`) and each criterion's episode flag
    (`success_reason_<name>`, `failure_reason_<name>`), as JAX's."""
    n = episode_step_count.shape[0]
    dev = episode_step_count.device

    def fold(criteria, active, flags):
        ep = torch.zeros(n, dtype=torch.bool, device=dev)
        new_flags = dict(flags)
        for name in active:
            crit = criteria[name]
            old = flags.get(name, torch.zeros(n, dtype=torch.bool, device=dev))
            new_flags[name] = (~ep & crit) | old
            ep = ep | crit
        return ep, new_flags

    ep_succ, new_s = fold(success_criteria, cfg.active_success(success_criteria), success_flags)
    ep_fail, new_f = fold(failure_criteria, cfg.active_failure(failure_criteria), failure_flags)
    timeout = episode_step_count >= cfg.max_episode_length - 1
    should_reset = ep_succ | ep_fail | timeout
    succ_t = ep_succ & should_reset
    fail_t = ep_fail & ~ep_succ & should_reset
    tout_t = timeout & ~ep_succ & ~ep_fail & should_reset
    f = lambda m: m.float()
    term_reward = (f(succ_t) * cfg.success_reward - f(fail_t) * cfg.failure_penalty
                   - f(tout_t) * cfg.timeout_penalty)
    info = {"success": succ_t, "failure": fail_t, "timeout": tout_t,
            "success_rate": f(succ_t).mean(), "failure_rate": f(fail_t).mean(),
            "timeout_rate": f(tout_t).mean(),
            **{f"success_{k}": f(success_criteria[k]).mean()
               for k in cfg.active_success(success_criteria)},
            **{f"failure_{k}": f(failure_criteria[k]).mean()
               for k in cfg.active_failure(failure_criteria)},
            # each criterion's episode flag (before the reset clears it)
            **{f"success_reason_{k}": v for k, v in new_s.items()},
            **{f"failure_reason_{k}": v for k, v in new_f.items()}}
    comps = {
        "termination_success": f(succ_t),
        "termination_success_weighted": f(succ_t) * cfg.success_reward,
        "termination_failure_penalty": f(fail_t),
        "termination_failure_penalty_weighted": -f(fail_t) * cfg.failure_penalty,
        "termination_timeout_penalty": f(tout_t),
        "termination_timeout_penalty_weighted": -f(tout_t) * cfg.timeout_penalty,
    }
    return should_reset, info, term_reward, comps, new_s, new_f
