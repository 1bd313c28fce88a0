"""Continuous-batching inference engine of the PyTorch port.

Public surface:

    EngineConfig, InferenceEngine     — engine loop (serve/engine.py)
    SamplingParams                    — per-request sampling (serve/sampling.py)
    Request, Scheduler                — admission/preemption (serve/scheduler.py)
    PagedCacheConfig, PagedKVCache    — block pool (serve/kv_cache.py)
"""
from .engine import (EngineConfig, EngineStats, InferenceEngine,
                     QueueFullError)
from .kv_cache import BlockPool, PagedCacheConfig, PagedKVCache
from .sampling import SamplingParams, sample_tokens
from .scheduler import Request, Scheduler

__all__ = [
    "BlockPool", "EngineConfig", "EngineStats", "InferenceEngine",
    "PagedCacheConfig", "PagedKVCache", "QueueFullError", "Request",
    "SamplingParams", "Scheduler", "sample_tokens",
]
