"""BaseTask: the no-op smoke/dev task."""

from dexrobot_isaac_tpu_torch.envs.tasks.api import DexTask


class BaseTask(DexTask):
    name = "BaseTask"
