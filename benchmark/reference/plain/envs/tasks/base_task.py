"""BaseTask: the no-op smoke/dev task."""

from benchmark.reference.plain.envs.tasks.api import DexTask


class BaseTask(DexTask):
    name = "BaseTask"
