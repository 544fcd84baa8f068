"""mx.mod namespace: the symbolic training interface."""
from .base_module import BaseModule, BatchEndParam  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
from .sequential_module import SequentialModule  # noqa: F401
from .python_module import PythonModule, PythonLossModule  # noqa: F401
from .sharded import ShardedModule  # noqa: F401
from .pipeline_module import PipelineModule  # noqa: F401
