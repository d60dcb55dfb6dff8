"""Serving public API of the port."""
from .engine import Completion, EngineStats, InferenceEngine, Request  # noqa: F401
from .faults import FaultError, FaultInjector  # noqa: F401
from .kv_cache import BlockAllocator, BlockTable, OutOfBlocks, blocks_for  # noqa: F401
from .sampling import SamplingParams  # noqa: F401
from .scheduler import ContinuousScheduler, FifoScheduler  # noqa: F401
