"""The plain SPD solve of the reference engine."""

from __future__ import annotations

import torch


def spd_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


spd_solve = spd_solve_plain
