"""Continuous-batching inference engine of the PyTorch port.

Public surface:

    EngineConfig, InferenceEngine     — engine loop (serve/engine.py)
    SamplingParams                    — per-request sampling (serve/sampling.py)
    Request, Scheduler                — admission/preemption (serve/scheduler.py)
    PagedCacheConfig, PagedKVCache    — block pool (serve/kv_cache.py)
    RadixPrefixCache, PrefixHit       — shared prefixes (serve/prefix_cache.py)
    NgramProposer, DraftRunner        — speculation (serve/spec.py)
"""
from .engine import (EngineConfig, EngineStats, InferenceEngine,
                     QueueFullError)
from .kv_cache import BlockPool, PagedCacheConfig, PagedKVCache
from .prefix_cache import PrefixHit, RadixPrefixCache
from .sampling import SamplingParams, sample_tokens
from .scheduler import Request, Scheduler
from .spec import DraftRunner, NgramProposer

__all__ = [
    "BlockPool", "DraftRunner", "EngineConfig", "EngineStats",
    "InferenceEngine", "NgramProposer", "PagedCacheConfig", "PagedKVCache",
    "PrefixHit", "QueueFullError", "RadixPrefixCache", "Request",
    "SamplingParams", "Scheduler", "sample_tokens",
]
