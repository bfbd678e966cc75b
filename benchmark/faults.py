"""Faults planted under the timed path, for the check that each one makes
`correct` come out false (the CPU tests, and `calibrate --fault` on the
card for the training cell's readings). A fault wraps the port's step or
learner; the benchmark's own runs never use one."""

from __future__ import annotations

import torch


class Fault:
    loops = ("step", "train")   # the loops whose timed path the fault can break

    def wrap_step(self, fused, step):
        return step

    def wrap_learner(self, learner) -> None:
        pass


class Unchanged(Fault):
    """A step that returns its state unchanged: the env step leaves its rows
    as they were; the learner's optimizer step returns its parameters."""

    def wrap_step(self, fused, step):
        def faulty(fs, actions, operands=None):
            before = (fs.rows_f.clone(), fs.rows_i.clone())
            out = step(fs, actions, operands)
            out[0].rows_f.copy_(before[0])
            out[0].rows_i.copy_(before[1])
            return out
        return faulty

    def wrap_learner(self, learner) -> None:
        apply = learner._apply_updates
        learner._apply_updates = lambda params, opt, grads, lr: (
            params, apply(params, opt, grads, lr)[1])


class HalfBatch(Fault):
    """Half of the batch left out: the env step advances the first half of
    the envs only and gives the rest the first half's mean reward; the
    learner's loss is the mean over the first half of each minibatch."""

    def wrap_step(self, fused, step):
        def faulty(fs, actions, operands=None):
            h = actions.shape[0] // 2
            before = (fs.rows_f[:, h:].clone(), fs.rows_i[:, h:].clone())
            new, obs, rew, done, ex = step(fs, actions, operands)
            new.rows_f[:, h:] = before[0]
            new.rows_i[:, h:] = before[1]
            rew = torch.cat([rew[:h], rew[:h].mean().expand(rew.shape[0] - h)])
            return new, obs, rew, done, ex
        return faulty

    def wrap_learner(self, learner) -> None:
        loss = learner._loss

        def faulty(params, obs_rms, mb):
            total = loss(params, obs_rms, [x[:x.shape[0] // 2] for x in mb])[0]
            return (total, *loss(params, obs_rms, mb)[1:])
        learner._loss = faulty


class Altered(Fault):
    """An answer altered where it is produced: one observation of the env
    step moved by 1, one sampled action of the learner by 0.01."""

    def wrap_step(self, fused, step):
        def faulty(fs, actions, operands=None):
            new, obs, rew, done, ex = step(fs, actions, operands)
            obs = obs.clone()
            obs[0, 0] += 1.0
            return new, obs, rew, done, ex
        return faulty

    def wrap_learner(self, learner) -> None:
        act = learner.act

        def faulty(state, obs, noise=None):
            action, *rest = act(state, obs, noise)
            action = action.clone()
            action[0, 0] += 0.01
            return (action, *rest)
        learner.act = faulty


class ResetPoseKept(Fault):
    """A masked reset that zeroes the envs' velocities, step counts and
    actions but leaves them in the pose they had before the step. The
    learner's first rollout rarely resets and is left as it is."""

    loops = ("step",)

    def wrap_step(self, fused, step):
        def faulty(fs, actions, operands=None):
            before = fused.unpack(fs).physics
            new, obs, rew, done, ex = step(fs, actions, operands)
            if bool(done.any()):
                after = fused.unpack(new)
                for k in ("q", "box_pos", "box_quat", "box2_pos", "box2_quat"):
                    if getattr(after.physics, k, None) is not None:
                        getattr(after.physics, k)[done] = getattr(before, k)[done]
                packed = fused.pack(after)
                new.rows_f.copy_(packed.rows_f)
                new.rows_i.copy_(packed.rows_i)
            return new, obs, rew, done, ex
        return faulty


class SkippedMinibatches(Fault):
    """Half of the batch left out another way: each epoch of the learner
    updates on its first half of minibatches only and skips the rest. The
    env step has no minibatches and is left as it is."""

    loops = ("train",)

    def wrap_learner(self, learner) -> None:
        update = learner._update_minibatch
        n_mb = max(1, learner.cfg.batch_size // learner.cfg.minibatch)
        calls = [0]

        def faulty(carry, mb):
            j = calls[0] % n_mb
            calls[0] += 1
            return update(carry, mb) if j < n_mb // 2 else (carry, carry[-1] * 0.0)
        learner._update_minibatch = faulty


FAULTS = {"unchanged": Unchanged, "half_batch": HalfBatch, "altered": Altered,
          "reset_pose_kept": ResetPoseKept, "skipped_minibatches": SkippedMinibatches}
