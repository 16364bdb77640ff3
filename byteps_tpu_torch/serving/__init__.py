"""Continuous-batching serving: the engine over dense slot rows or its
fp / int8 / tensor-parallel block pools, the row-copy and radix prefix
caches, speculative decoding and the TCP tier."""

from .blocks import (BlockAllocator, BlocksExhaustedError, BlockTable,
                     PagedSlotPool, init_paged_cache)
from .engine import Request, RequestState, ServingEngine, resolve_device
from .frontend import (RemoteServeClient, ServeClient, ServeConnectionError,
                       ServeFrontend, ServeReplyError, serve, serve_from_env)
from .metrics import ServeMetrics, get_serve_metrics
from .prefix import PagedPrefixCache, PrefixCache, weights_fingerprint
from .scheduler import AdmissionError, QueueFullError, ServeScheduler
from .slots import SlotPool
from .spec import NgramProposer

__all__ = ["AdmissionError", "BlockAllocator", "BlockTable",
           "BlocksExhaustedError", "NgramProposer", "PagedPrefixCache",
           "PagedSlotPool", "PrefixCache", "QueueFullError",
           "RemoteServeClient", "Request", "RequestState", "ServeClient",
           "ServeConnectionError", "ServeFrontend", "ServeMetrics",
           "ServeReplyError", "ServeScheduler", "ServingEngine", "SlotPool",
           "get_serve_metrics", "init_paged_cache", "resolve_device",
           "serve", "serve_from_env", "weights_fingerprint"]
