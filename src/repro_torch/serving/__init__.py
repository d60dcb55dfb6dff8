"""Serving public API of the port."""
from .engine import Completion, EngineStats, InferenceEngine, Request  # noqa: F401
from .sampling import SamplingParams  # noqa: F401
from .scheduler import FifoScheduler  # noqa: F401
