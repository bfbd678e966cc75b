"""Deployment export: checkpoint -> standalone policy files (the port of
`dexrobot_isaac_tpu/rl/export.py`).

It reads the port's `.pt` checkpoints and the JAX package's `.ckpt` files
alike (rl/checkpoint.py), and needs no env or config: the network's layers
come from the parameter names and the observation width from the first
layer. Three formats:

- **npz**: the actor's weights and the observation normalization, read by
  `NumpyPolicy` (numpy only at inference). Self-describing (`num_layers`,
  `num_obs`, `norm_clip`).
- **bin**: the flat little-endian `DXP1` file of `native/policy_runtime`.
- **torchscript**: the actor as a scripted module, loadable from C++
  through libtorch.

The npz and the bin keep the JAX package's layout, a weight as (in, out)
row-major (flax's kernel layout, which `native/policy_runtime/dex_policy.cpp`
reads), so the port's (out, in) weights are transposed on the way out; a
JAX checkpoint exports to the same arrays and the same bin bytes from
either package. Everything is float32, whatever `compute_dtype` the network
trained in.

Inference is `PPOLearner.act_deterministic`: clip((obs - mean) / sqrt(var +
1e-5), +-5) -> MLP (ELU) -> mu -> clip(mu, +-1). An asymmetric actor-critic
exports its actor (`actor_i`, `mu`) only; a symmetric one its trunk
(`Dense_0..k-1`) and mu (`Dense_k`).

CLI: python -m dexrobot_isaac_tpu_torch.rl.export <ckpt> [--format npz|bin|torchscript]
     [--out PATH]   (default: the checkpoint's name with .npz, .bin or
     .torchscript.pt, so that a `.pt` checkpoint is never overwritten)
"""

from __future__ import annotations

import argparse
import os
import re
import struct
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from dexrobot_isaac_tpu_torch.rl.checkpoint import read_payload

NORM_EPS = 1e-5
NORM_CLIP = 5.0
EXTENSIONS = {"npz": ".npz", "bin": ".bin", "torchscript": ".torchscript.pt"}


def extract_actor(ckpt_path: str) -> Dict[str, np.ndarray]:
    """The actor's weights and normalization from a checkpoint of either
    format: layer_{i}_w/b ((in, out) layout), mu_w/b, obs_mean, obs_std and
    the scalars num_obs, num_layers, norm_clip."""
    payload = read_payload(ckpt_path)
    params = {k[len("layers."):]: v for k, v in payload["params"].items()
              if k.startswith("layers.")}
    names = {k.rsplit(".", 1)[0] for k in params}

    def wb(name) -> Tuple[np.ndarray, np.ndarray]:
        w = params[f"{name}.weight"].detach().cpu().float().numpy()
        return (np.ascontiguousarray(w.T),
                params[f"{name}.bias"].detach().cpu().float().numpy())

    def numbered(prefix):
        return sorted(int(m.group(1)) for n in names if (m := re.fullmatch(prefix + r"_(\d+)", n)))

    if any(n.startswith("actor_") for n in names):
        layers = [wb(f"actor_{i}") for i in numbered("actor")]
        mu_w, mu_b = wb("mu")
    else:
        idx = numbered("Dense")
        if len(idx) < 3:
            raise ValueError(f"unrecognized network parameters: {sorted(names)}")
        layers = [wb(f"Dense_{i}") for i in idx[:-2]]
        mu_w, mu_b = wb(f"Dense_{idx[-2]}")
    num_obs = int(layers[0][0].shape[0])
    rms = payload["obs_rms"]
    mean = rms["mean"].cpu().numpy().astype(np.float32)[:num_obs]
    std = np.sqrt(rms["var"].cpu().numpy().astype(np.float32)[:num_obs] + NORM_EPS)
    out: Dict[str, np.ndarray] = {
        "num_obs": np.asarray(num_obs, np.int64),
        "num_layers": np.asarray(len(layers), np.int64),
        "norm_clip": np.asarray(NORM_CLIP, np.float32),
        "obs_mean": mean,
        "obs_std": std,
        "mu_w": mu_w,
        "mu_b": mu_b,
    }
    for i, (w, b) in enumerate(layers):
        out[f"layer_{i}_w"] = w
        out[f"layer_{i}_b"] = b
    return out


class NumpyPolicy:
    """The deterministic policy in numpy (no torch at inference)."""

    def __init__(self, weights: Dict[str, np.ndarray]):
        n = int(weights["num_layers"])
        self.layers = [(weights[f"layer_{i}_w"], weights[f"layer_{i}_b"]) for i in range(n)]
        self.mu_w = weights["mu_w"]
        self.mu_b = weights["mu_b"]
        self.obs_mean = weights["obs_mean"]
        self.obs_std = weights["obs_std"]
        self.norm_clip = float(weights["norm_clip"])
        self.num_obs = int(weights["num_obs"])

    @classmethod
    def load(cls, path: str) -> "NumpyPolicy":
        return cls(dict(np.load(path)))

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        """obs (..., >= num_obs) -> action (..., num_actions) in [-1, 1]."""
        x = np.asarray(obs, np.float32)[..., :self.num_obs]
        x = (x - self.obs_mean) / self.obs_std
        x = np.clip(x, -self.norm_clip, self.norm_clip)
        for w, b in self.layers:
            x = x @ w + b
            x = np.where(x > 0, x, np.expm1(np.minimum(x, 0.0)))  # ELU
        return np.clip(x @ self.mu_w + self.mu_b, -1.0, 1.0)


def export_npz(ckpt_path: str, out_path: str) -> str:
    np.savez(out_path, **extract_actor(ckpt_path))
    return out_path


def export_flat_binary(ckpt_path: str, out_path: str) -> str:
    """The flat little-endian file of native/policy_runtime:

    magic 'DXP1' | i32 num_layers | i32 num_obs | i32 num_actions |
    f32 norm_clip | f32 obs_mean[num_obs] | f32 obs_std[num_obs] |
    per layer (trunk..., then mu): i32 in | i32 out | f32 W[in*out]
    (row-major, (in, out)) | f32 b[out]
    """
    w = extract_actor(ckpt_path)
    n = int(w["num_layers"])
    with open(out_path, "wb") as f:
        f.write(b"DXP1")
        f.write(struct.pack("<iii f", n + 1, int(w["num_obs"]), int(w["mu_w"].shape[1]),
                            float(w["norm_clip"])))
        f.write(w["obs_mean"].astype("<f4").tobytes())
        f.write(w["obs_std"].astype("<f4").tobytes())
        mats = [(w[f"layer_{i}_w"], w[f"layer_{i}_b"]) for i in range(n)]
        for W, b in mats + [(w["mu_w"], w["mu_b"])]:
            f.write(struct.pack("<ii", W.shape[0], W.shape[1]))
            f.write(np.ascontiguousarray(W, "<f4").tobytes())
            f.write(b.astype("<f4").tobytes())
    return out_path


class _Actor(nn.Module):
    """The exported actor: normalization, the ELU trunk, mu, the clip."""

    def __init__(self, w: Dict[str, np.ndarray]):
        super().__init__()
        mods: List[nn.Module] = []

        def linear(k, b):
            lin = nn.Linear(k.shape[0], k.shape[1])
            lin.weight.data = torch.from_numpy(np.ascontiguousarray(k.T))
            lin.bias.data = torch.from_numpy(b.copy())
            return lin

        for i in range(int(w["num_layers"])):
            mods += [linear(w[f"layer_{i}_w"], w[f"layer_{i}_b"]), nn.ELU()]
        mods.append(linear(w["mu_w"], w["mu_b"]))
        self.net = nn.Sequential(*mods)
        self.register_buffer("obs_mean", torch.from_numpy(w["obs_mean"].copy()))
        self.register_buffer("obs_std", torch.from_numpy(w["obs_std"].copy()))
        self.norm_clip = float(w["norm_clip"])
        self.num_obs = int(w["num_obs"])

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs[..., :self.num_obs]
        x = (x - self.obs_mean) / self.obs_std
        x = torch.clamp(x, -self.norm_clip, self.norm_clip)
        return torch.clamp(self.net(x), -1.0, 1.0)


def export_torchscript(ckpt_path: str, out_path: str) -> str:
    """The actor scripted as a TorchScript module (libtorch-loadable)."""
    torch.jit.script(_Actor(extract_actor(ckpt_path)).eval()).save(out_path)
    return out_path


EXPORTERS = {"npz": export_npz, "bin": export_flat_binary, "torchscript": export_torchscript}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Export a training checkpoint for deployment")
    ap.add_argument("checkpoint", help="a .pt checkpoint of the port or a JAX package .ckpt")
    ap.add_argument("--format", choices=list(EXPORTERS), default="npz")
    ap.add_argument("--out", default=None, help="output path")
    args = ap.parse_args(argv)
    out = args.out or os.path.splitext(args.checkpoint)[0] + EXTENSIONS[args.format]
    EXPORTERS[args.format](args.checkpoint, out)
    print(f"Exported {args.format} policy: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
