"""Experiment directory management (the port's copy of
`dexrobot_isaac_tpu/utils/experiment.py`): every run lives in
`runs_all/<task>_<mode>_<timestamp>/`, a pruned `runs/` workspace holds
symlinks to the newest maxTrainRuns/maxTestRuns runs, `latest_train` /
`latest_test` track the newest run of each mode, and each run keeps its
composed config (`config.json`) and git metadata. Checkpoints are the
port's `.pt` files (rl/checkpoint.py).
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
from typing import Dict, Optional


class ExperimentManager:
    def __init__(
        self,
        base_dir: str = ".",
        max_train_runs: int = 10,
        max_test_runs: int = 10,
    ):
        self.base_dir = os.path.abspath(base_dir)
        self.runs_all = os.path.join(self.base_dir, "runs_all")
        self.runs = os.path.join(self.base_dir, "runs")
        self.max_runs = {"train": max_train_runs, "test": max_test_runs}
        os.makedirs(self.runs_all, exist_ok=True)
        os.makedirs(self.runs, exist_ok=True)

    def create_run(
        self, task_name: str, mode: str, experiment_name: Optional[str] = None,
        cfg: Optional[Dict] = None,
    ) -> str:
        """Create a run dir, snapshot config+git, update symlinks; returns path."""
        stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        name = experiment_name or f"{task_name}_{mode}_{stamp}"
        run_dir = os.path.join(self.runs_all, name)
        os.makedirs(run_dir, exist_ok=True)
        os.makedirs(os.path.join(run_dir, "nn"), exist_ok=True)

        if cfg is not None:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(cfg, f, indent=2)
        self._snapshot_git(run_dir)

        # workspace symlink + latest_<mode>
        link = os.path.join(self.runs, name)
        _force_symlink(run_dir, link)
        _force_symlink(run_dir, os.path.join(self.runs, f"latest_{mode}"))
        self._prune(mode)
        return run_dir

    def _snapshot_git(self, run_dir: str) -> None:
        meta = {}
        for key, cmd in [
            ("commit", ["git", "rev-parse", "HEAD"]),
            ("branch", ["git", "rev-parse", "--abbrev-ref", "HEAD"]),
        ]:
            try:
                meta[key] = subprocess.run(
                    cmd, capture_output=True, text=True, timeout=5,
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                ).stdout.strip()
            except Exception:
                meta[key] = "unknown"
        try:
            diff = subprocess.run(
                ["git", "diff", "HEAD"], capture_output=True, text=True,
                timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)),
            ).stdout
        except Exception:
            diff = ""
        with open(os.path.join(run_dir, "git_metadata.txt"), "w") as f:
            f.write(f"commit: {meta.get('commit')}\nbranch: {meta.get('branch')}\n")
        if diff:
            with open(os.path.join(run_dir, "git_diff.patch"), "w") as f:
                f.write(diff)

    def _prune(self, mode: str) -> None:
        """Keep only the newest max_runs[mode] symlinks of that mode."""
        entries = []
        for name in os.listdir(self.runs):
            path = os.path.join(self.runs, name)
            if name.startswith("latest_") or not os.path.islink(path):
                continue
            if f"_{mode}_" in name or name.endswith(f"_{mode}"):
                entries.append((os.lstat(path).st_mtime, path))
        entries.sort(reverse=True)
        for _, path in entries[self.max_runs[mode]:]:
            os.unlink(path)


def _force_symlink(target: str, link: str) -> None:
    if os.path.islink(link) or os.path.exists(link):
        os.unlink(link)
    os.symlink(target, link)


def resolve_checkpoint(spec: str, base_dir: str = ".") -> str:
    """Smart checkpoint resolution (parity: cli_utils.py:94-168).

    Accepts: a file path, a run dir (newest checkpoint inside), `latest` /
    `latest_train` / `latest_test` symlinks, or a partial run-name match.
    """
    runs = os.path.join(os.path.abspath(base_dir), "runs")
    if spec in ("latest", "latest_train", "latest_test"):
        mode = "train" if spec in ("latest", "latest_train") else "test"
        link = os.path.join(runs, f"latest_{mode}")
        if os.path.exists(link) and _newest_checkpoint(link) is not None:
            spec = link
        else:
            # the newest run may have died before saving; fall back to the
            # newest checkpoint across all runs of this mode
            runs_all = os.path.join(os.path.abspath(base_dir), "runs_all")
            candidates = []
            if os.path.isdir(runs_all):
                for name in os.listdir(runs_all):
                    if f"_{mode}_" in name:
                        found = _newest_checkpoint(os.path.join(runs_all, name))
                        if found:
                            candidates.append((os.stat(found).st_mtime, found))
            if not candidates:
                raise FileNotFoundError(
                    f"No checkpoint found for '{spec}' under {runs} or {runs_all}"
                )
            return max(candidates)[1]
    if os.path.isdir(spec):
        found = _newest_checkpoint(spec)
        if found is None:
            raise FileNotFoundError(f"No checkpoint found under {spec}")
        return found
    if os.path.isfile(spec):
        return spec
    # partial name match over runs workspace
    if os.path.isdir(runs):
        matches = [n for n in os.listdir(runs) if spec in n]
        if len(matches) == 1:
            return resolve_checkpoint(os.path.join(runs, matches[0]), base_dir)
        if len(matches) > 1:
            raise ValueError(f"Ambiguous checkpoint '{spec}': {matches}")
    raise FileNotFoundError(f"Cannot resolve checkpoint: {spec}")


def _newest_checkpoint(run_dir: str) -> Optional[str]:
    best, best_mtime = None, -1.0
    for root, _, files in os.walk(run_dir, followlinks=True):
        for f in files:
            if f.endswith(".pt"):
                p = os.path.join(root, f)
                m = os.stat(p).st_mtime
                if m > best_mtime:
                    best, best_mtime = p, m
    return best
