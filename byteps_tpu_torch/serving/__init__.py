"""Continuous-batching serving: the engine over dense slot rows or its
fp / int8 / tensor-parallel block pools, the row-copy and radix prefix
caches, speculative decoding, the TCP tier (cancel, router epochs), the
disaggregated prefill/decode KV ship, and the router tier over serve
replicas (placement, failover, HA journal, SLO admission, autoscale)."""

from .autoscale import (AutoscaleController, OverloadShedError,
                        ReplicaLauncher, ScaleDecision, ScalePolicy,
                        TenantShares, TierSignals, normalize_slo)

from .blocks import (BlockAllocator, BlocksExhaustedError, BlockTable,
                     PagedSlotPool, init_paged_cache)
from .disagg import (KVShipAbortedError, KVShipDigestError, KVShipError,
                     KVShipGeometryError, KVShipSequenceError, KVStager,
                     pool_geometry, ship_parked)
from .engine import (EpochFencedError, Request, RequestState, ServingEngine,
                     resolve_device)
from .frontend import (OP_CANCEL, OP_JOURNAL, OP_KV_BLOCKS, OP_PING,
                       OP_STATS, OP_STREAM, OP_SUBMIT, RemoteServeClient,
                       ServeClient, ServeConnectionError, ServeFrontend,
                       ServeReplyError, serve, serve_from_env)
from .journal import JournalSender
from .metrics import ServeMetrics, get_serve_metrics
from .prefix import PagedPrefixCache, PrefixCache, weights_fingerprint
from .router import (ReplicaLostError, ReplicaState, RouterFrontend,
                     RouterStandbyError, ServeRouter, WeightsMismatchError,
                     router_from_env, serve_router)
from .scheduler import AdmissionError, QueueFullError, ServeScheduler
from .slots import SlotPool
from .spec import NgramProposer

__all__ = ["AdmissionError", "AutoscaleController", "BlockAllocator",
           "BlockTable", "BlocksExhaustedError", "EpochFencedError",
           "JournalSender", "KVShipAbortedError", "KVShipDigestError",
           "KVShipError", "KVShipGeometryError", "KVShipSequenceError",
           "KVStager", "NgramProposer", "OP_CANCEL", "OP_JOURNAL",
           "OP_KV_BLOCKS", "OP_PING", "OP_STATS", "OP_STREAM", "OP_SUBMIT",
           "OverloadShedError", "PagedPrefixCache", "PagedSlotPool",
           "PrefixCache", "QueueFullError", "RemoteServeClient",
           "ReplicaLauncher", "ReplicaLostError", "ReplicaState", "Request",
           "RequestState", "RouterFrontend", "RouterStandbyError",
           "ScaleDecision", "ScalePolicy", "ServeClient",
           "ServeConnectionError", "ServeFrontend", "ServeMetrics",
           "ServeReplyError", "ServeRouter", "ServeScheduler",
           "ServingEngine", "SlotPool", "TenantShares", "TierSignals",
           "WeightsMismatchError", "get_serve_metrics", "init_paged_cache",
           "normalize_slo", "pool_geometry", "resolve_device",
           "router_from_env", "serve", "serve_from_env", "serve_router",
           "ship_parked", "weights_fingerprint"]
