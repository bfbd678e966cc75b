"""Running mean/std normalization (torch): the port of
`dexrobot_isaac_tpu/rl/running_stats.py`.

rl_games' RunningMeanStd for observations and value targets, updated with
Chan's parallel algorithm from a batch's moments. Immutable like the JAX
dataclass: every update returns a new object of tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RunningMeanStd:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # scalar

    @staticmethod
    def create(shape, device="cpu") -> "RunningMeanStd":
        return RunningMeanStd(
            mean=torch.zeros(shape, dtype=torch.float32, device=device),
            var=torch.ones(shape, dtype=torch.float32, device=device),
            count=torch.tensor(1e-4, dtype=torch.float32, device=device),
        )

    def update(self, batch: torch.Tensor) -> "RunningMeanStd":
        """Update with a batch whose leading axes are reduced."""
        lead = tuple(range(batch.ndim - self.mean.ndim))
        b_count = torch.tensor(float(math.prod(batch.shape[:len(lead)])),
                               dtype=torch.float32, device=batch.device)
        return self.update_with_moments(batch.mean(dim=lead),
                                        batch.var(dim=lead, unbiased=False), b_count)

    def update_with_moments(self, b_mean, b_var, b_count) -> "RunningMeanStd":
        """Chan's parallel update from precomputed batch moments."""
        delta = b_mean - self.mean
        tot = self.count + b_count
        new_mean = self.mean + delta * (b_count / tot)
        m2 = self.var * self.count + b_var * b_count + delta ** 2 * (self.count * b_count / tot)
        return RunningMeanStd(new_mean, m2 / tot, tot)

    def normalize(self, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
        out = (x - self.mean) / torch.sqrt(self.var + 1e-5)
        return out.clamp(-clip, clip)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sqrt(self.var + 1e-5) + self.mean

    def to_dict(self):
        return {"mean": self.mean, "var": self.var, "count": self.count}
