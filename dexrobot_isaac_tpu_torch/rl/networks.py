"""Actor-critic network for PPO (torch): the port of
`dexrobot_isaac_tpu/rl/networks.py`.

rl_games' network config (cfg/train/BaseTaskPPO.yaml:8-31): a shared MLP
[512, 256, 128] with ELU, a linear mu head, a state-independent learnable
log-std clamped to [-5, 2], and a value head. With `num_states > 0` the input
is [policy obs | critic states]; separate actor and critic trunks read the
two slices (the asymmetric actor-critic).

The layers carry flax's names (`Dense_<i>` in the shared net; `actor_<i>`,
`critic_<i>`, `mu`, `value` in the asymmetric one) and flax's default init:
lecun-normal kernels (a normal truncated at two standard deviations, scaled
to variance 1/fan_in) and zero biases. `compute_dtype=torch.bfloat16` runs
the matmuls and activations in bf16 while the parameters stay float32, as
flax's `Dense(dtype=...)` does; the outputs are float32.

The MLP's products are plain `torch` matmuls: the JAX package leaves them to
XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax's `lecun_normal` on a torch (out, in) weight: fan_in = in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.mul_(std)
    return w


class ActorCritic(nn.Module):
    def __init__(self, num_obs: int, num_actions: int, units: Sequence[int] = (512, 256, 128),
                 num_states: int = 0, compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_obs, self.num_states = num_obs, num_states
        self.compute_dtype = compute_dtype
        layers: Dict[str, nn.Linear] = {}
        if num_states > 0:
            for prefix, width in (("actor", num_obs), ("critic", num_states)):
                for i, u in enumerate(units):
                    layers[f"{prefix}_{i}"] = nn.Linear(width, u)
                    width = u
            layers["mu"] = nn.Linear(units[-1], num_actions)
            layers["value"] = nn.Linear(units[-1], 1)
            self._heads = ("mu", "value")
        else:
            width = num_obs
            for i, u in enumerate(units):
                layers[f"Dense_{i}"] = nn.Linear(width, u)
                width = u
            k = len(units)
            layers[f"Dense_{k}"] = nn.Linear(width, num_actions)
            layers[f"Dense_{k + 1}"] = nn.Linear(width, 1)
            self._heads = (f"Dense_{k}", f"Dense_{k + 1}")
        self.layers = nn.ModuleDict(layers)
        self.n_trunk = len(units)
        self.log_std = nn.Parameter(torch.zeros(num_actions))  # sigma = 1
        for lin in self.layers.values():
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        lin = self.layers[name]
        dt = self.compute_dtype
        return F.linear(x, lin.weight.to(dt), lin.bias.to(dt))

    def _trunk(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_trunk):
            x = F.elu(self._dense(f"{prefix}_{i}", x))
        return x

    def forward(self, obs: torch.Tensor):
        """obs (..., num_obs + num_states) -> (mu, log_std, value) in f32:
        mu (..., A), log_std broadcast to mu's shape, value (...)."""
        x = obs.to(self.compute_dtype)
        if self.num_states > 0:
            a = self._trunk("actor", x[..., :x.shape[-1] - self.num_states])
            c = self._trunk("critic", x[..., x.shape[-1] - self.num_states:])
        else:
            a = c = self._trunk("Dense", x)
        mu = self._dense(self._heads[0], a)
        value = self._dense(self._heads[1], c)
        log_std = self.log_std.clamp(-5.0, 2.0)
        return mu.float(), log_std.expand(mu.shape), value[..., 0].float()
