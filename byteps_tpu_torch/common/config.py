"""Typed runtime configuration — the port's subset of
``byteps_tpu/common/config.py``.

Only the knobs the ported slices read are carried over, under the same
``BYTEPS_*`` / ``DMLC_*`` environment names so one environment drives
either package: the logging pair ``common/logging.py`` needs, the
``BYTEPS_SERVE_*`` knobs ``serving/frontend.py:serve_from_env`` reads,
the ``BYTEPS_DISAGG_*`` knobs of the disaggregated KV ship, the router
tier's ``BYTEPS_ROUTER_*``, ``BYTEPS_DISAGG``, ``BYTEPS_SLO_*`` and
``BYTEPS_AUTOSCALE_*`` knobs with the ``BYTEPS_HEARTBEAT_*`` pair, the
worker knobs ``api.init``, the eager push_pull engine,
``training.Trainer`` and ``make_data_parallel_step`` read (the DMLC
cluster contract, partition bytes and scheduling credit, the wire
dtype, the mesh shape), the compression knobs (``BYTEPS_COMPRESSION``
and its ``_RATIO``, ``_SEED``, ``_OVERRIDES``, ``_REPLY``,
``BYTEPS_MIN_COMPRESS_BYTES``), the async parameter-server tier's
(``BYTEPS_ENABLE_ASYNC``, ``BYTEPS_SERVER_ADDRS``, ``DMLC_NUM_SERVER``,
``BYTEPS_USE_HASH_KEY``, ``BYTEPS_FAILOVER``, the ``BYTEPS_RETRY_*``
policy, ``BYTEPS_WIRE_WINDOW`` / ``_FANOUT`` and the
``BYTEPS_SERVER_*PROFILE*`` timeline), and the observability trio
(``BYTEPS_TRACE_PATH``, which the worker path's tracer honours;
``BYTEPS_METRICS_PORT`` and ``BYTEPS_TRACE_RPC``).  Knobs naming
features the port does not have yet (the metrics scrape, RPC trace ids,
hierarchical push/pull, the Unix socket and shared-memory transports)
are still parsed, so that a non-default value is refused loudly instead
of ignored.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return int(v)


def _env_opt_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None or v == "" else int(v)


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.lower() not in ("0", "false", "no", "off", "")


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_opt_bool(name: str) -> Optional[bool]:
    """Tri-state: unset/"" -> None (auto), else truthiness like _env_bool."""
    v = os.environ.get(name)
    if v is None or v == "":
        return None
    return v.lower() not in ("0", "false", "no", "off", "")


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return float(v)


def _env_opt_float(name: str) -> Optional[float]:
    v = os.environ.get(name)
    return None if v is None or v == "" else float(v)


@dataclasses.dataclass
class Config:
    """Snapshot of the port's knobs (defaults as in the JAX package)."""

    # --- logging --------------------------------------------------------
    log_level: str = "WARNING"
    log_hide_time: bool = False

    # --- worker / training (api.py, engine/, training/) ----------------
    num_worker: int = 1            # DMLC_NUM_WORKER: processes, one GPU each
    worker_id: int = 0             # DMLC_WORKER_ID: this process's rank
    local_rank: Optional[int] = None   # BYTEPS_LOCAL_RANK (launcher)
    local_size: Optional[int] = None   # BYTEPS_LOCAL_SIZE (launcher)
    partition_bytes: int = 4_096_000   # push_pull bucket / partition bytes
    # the partition bound is aligned down to this many bytes, so every
    # partition splits evenly over a group (the JAX package's value)
    partition_align: int = 256
    # engine credit in bytes; 0 = partition_bytes * (group_size + 1)
    scheduling_credit: int = 0
    group_size: int = 4
    wire_dtype: str = ""           # "" (no cast) | "bf16" | "fp16"
    mesh_shape: str = ""           # e.g. "dp=4" or "dcn=2,dp=2"; "" = dp
    force_distributed: bool = False  # a dcn axis of 2 on one host
    debug_sample_tensor: str = ""  # log first/last values of matching names
    enable_async: bool = False     # async PS mode (engine/async_ps.py)
    # hierarchical push/pull (the JAX engine/hierarchical.py); refused
    hierarchical: bool = False

    # --- async parameter-server tier (engine/async_ps.py, ps_server.py)
    num_server: int = 1            # DMLC_NUM_SERVER: PS shards
    use_hash_key: bool = False     # key->server sharding (global.cc:305-334)
    # explicit shard addresses "host:port,host:port"; "" = derive from
    # the DMLC contract (root port + 100 + shard index)
    server_addrs: str = ""
    # the server's per-key request timeline (reference docs/timeline.md)
    server_enable_profile: bool = False
    server_profile_output_path: str = "server_profile.json"
    server_key_to_profile: Optional[int] = None  # None = all keys
    # resilience of the PS client (resilience/policy.py from_config)
    retry_max_attempts: int = 3       # total tries per op; 1 = fail fast
    retry_backoff_ms: float = 50.0    # sleep before 2nd attempt
    retry_backoff_mult: float = 2.0   # exponential growth per attempt
    retry_jitter: float = 0.1         # +-10% randomization of each sleep
    retry_deadline_ms: float = 15_000.0  # per-op wall bound; 0 = none
    # None = auto (on when DMLC_NUM_WORKER <= 1): the OP_VERSION dedup of
    # retried mutations is only unambiguous for a single writer per key
    retry_version_guard: Optional[bool] = None
    heartbeat_interval_ms: float = 0.0   # 0 = no heartbeat thread
    heartbeat_miss_threshold: int = 3  # consecutive misses -> shard DOWN
    failover: bool = True  # degraded-mode re-routing around dead shards
    # in-flight request window per shard connection; 0 = serial client
    wire_window: int = 8
    # partitions of one op encoded and submitted ahead of the gather
    wire_fanout: int = 16

    # --- gradient compression (compression/; the JAX package's names
    # and defaults) ------------------------------------------------------
    # the PS tier's default wire scheme (RemoteStore's CompressionPolicy)
    compression: str = ""
    compression_min_bytes: int = 1024   # raw pass-through below this
    compression_overrides: str = ""     # "substring=scheme,..." per-name
    compression_ratio: float = 0.01     # k/n for topk / randomk
    compression_seed: int = 0           # base seed (randomk / int8 dither)
    compression_reply: str = ""         # server reply cast: ""|bf16|fp16

    # --- observability ---------------------------------------------------
    trace_path: str = ""           # chrome trace of the worker path
    trace_buffer: int = 100_000    # buffered events before a rollover flush
    metrics_port: int = 0          # /metrics scrape; refused (A10)
    trace_rpc: Optional[bool] = None  # RPC trace ids; refused (A10)

    # --- serving (serving/frontend.py serve_from_env) ------------------
    serve_port: int = 9000
    serve_slots: int = 8          # slot pool capacity (decode batch)
    serve_max_seq: int = 0        # 0 = model's max_seq_len
    serve_max_queue: int = 64     # bounded admission queue
    serve_prefill_credits: int = 0  # padded prefill tokens/tick; 0 = auto
    serve_temperature: float = 0.0  # 0 = greedy (engine-static)
    serve_top_k: Optional[int] = None
    serve_top_p: Optional[float] = None
    serve_eos_id: Optional[int] = None
    serve_model: str = ""         # "k=v,..." TransformerConfig overrides
    serve_checkpoint: str = ""    # a port checkpoint of the model's params
    serve_chunk: int = 0          # chunked prefill size in tokens; 0 = off
    serve_prefix_cache: bool = False  # prefix store (row-copy or radix)
    # the dense store's match granularity (tokens; unset = 16); a paged
    # store matches at serve_block, so another value is refused there
    serve_prefix_block: Optional[int] = None
    serve_prefix_mb: int = 256    # prefix store byte budget (MiB); 0 = inf
    serve_paged: bool = False     # paged KV pool; off = dense slot engine
    serve_block: int = 16         # KV block size in tokens
    serve_kv_mb: int = 0          # KV pool budget (MiB); 0 = dense-equiv
    serve_kv_dtype: str = ""      # "" (model dtype) or "int8"
    serve_paged_kernel: str = "auto"  # auto/on = the kernel; off = gather
    serve_spec: bool = False      # speculative decoding (n-gram proposals)
    serve_spec_k: int = 4         # max proposed tokens (rounds down to 2^n)
    serve_spec_ngram: int = 3     # longest trailing n-gram matched
    serve_tp: int = 1             # BYTEPS_TP: KV-head shards of the pool
    serve_client_timeout_ms: float = 300_000.0

    # --- the heartbeat's ping / STATS bound (router and PS client) ----
    heartbeat_timeout_ms: float = 1_000.0  # per-ping connect/read bound

    # --- serving router (serving/router.py) ----------------------------
    router_port: int = 9100
    router_replicas: str = ""     # "host:port,host:port" serve replicas
    router_credits: int = 16      # max in-flight requests per replica
    router_affinity: bool = True  # prefix-affinity placement (False = RR)
    router_affinity_block: int = 16  # leading tokens hashed for affinity
    # a request that cannot complete on any replica within this fails
    # typed (ReplicaLostError)
    router_deadline_ms: float = 60_000.0
    # no token from a replica leg within this => the leg is dead
    router_stream_timeout_ms: float = 30_000.0
    router_heartbeat_ms: float = 500.0   # replica health-check cadence
    router_miss_threshold: int = 3       # consecutive misses => DEAD
    # pinned weights fingerprint (hex); "" = first verified replica wins
    router_weights_fp: str = ""
    # router HA: priority-ordered router list (index 0 initially active)
    # and this router's own entry in it; "" = a single router
    router_peers: str = ""
    router_self: str = ""
    # takeover grace: re-ping the dead active this much later first
    router_epoch_timeout_ms: float = 500.0
    # per-tenant fair share "tenant=w,tenant=w"; "" = off
    router_tenant_weights: str = ""
    # per-replica roles "prefill,decode,both,...", positional with
    # router_replicas; "" = every replica colocated ("both")
    router_roles: str = ""
    # disaggregated placement when a prefill replica exists; off = the
    # prefill replicas are skipped (colocated decode-side prefill)
    disagg: bool = True

    # --- elastic capacity and SLO classes (serving/autoscale) ----------
    autoscale: bool = False        # run the controller beside the router
    autoscale_min: int = 1
    autoscale_max: int = 4
    autoscale_up: float = 0.8      # scale up above this normalized load
    autoscale_down: float = 0.3    # scale down below it
    autoscale_up_cooldown_ms: float = 5_000.0
    autoscale_down_cooldown_ms: float = 15_000.0
    autoscale_interval_ms: float = 1_000.0   # control-loop tick
    autoscale_window_ms: float = 5_000.0     # signal window
    autoscale_dry_run: bool = False  # log decisions without acting
    slo_default: str = "standard"   # class of a request without slo=
    # max estimated queue wait per class before the door sheds typed
    # (guaranteed never sheds)
    slo_standard_deadline_ms: float = 10_000.0
    slo_best_effort_deadline_ms: float = 1_000.0
    slo_service_estimate_ms: float = 500.0  # EWMA seed of service time
    slo_borrow: bool = True   # lend idle tenant credits (clawed back)

    # --- disaggregated prefill/decode (serving/disagg) -----------------
    disagg_ship_timeout_ms: float = 10_000.0  # per-block ack deadline
    disagg_ship_retries: int = 2   # digest-refusal resends per block
    disagg_parked_cap: int = 32    # parked unshipped KV entries kept

    # --- endpoint transport --------------------------------------------
    # "auto" and "tcp" are served over TCP (no Unix-socket / shm
    # rendezvous is advertised, so a JAX client's "auto" finds TCP);
    # "unix", "shm" and explicit "unix:/..." / "shm:/..." are refused
    transport: str = "auto"
    # per-endpoint overrides "host:port=spec,..." (tcp / auto only)
    transport_overrides: str = ""

    @staticmethod
    def from_env() -> "Config":
        return Config(
            log_level=_env_str("BYTEPS_LOG_LEVEL", "WARNING"),
            log_hide_time=_env_bool("BYTEPS_LOG_HIDE_TIME"),
            num_worker=_env_int("DMLC_NUM_WORKER", 1),
            local_rank=_env_opt_int("BYTEPS_LOCAL_RANK"),
            worker_id=_env_int("DMLC_WORKER_ID", 0),
            local_size=_env_opt_int("BYTEPS_LOCAL_SIZE"),
            partition_bytes=_env_int("BYTEPS_PARTITION_BYTES", 4_096_000),
            scheduling_credit=_env_int("BYTEPS_SCHEDULING_CREDIT", 0),
            wire_dtype=_env_str("BYTEPS_WIRE_DTYPE", ""),
            mesh_shape=_env_str("BYTEPS_MESH_SHAPE", ""),
            force_distributed=_env_bool("BYTEPS_FORCE_DISTRIBUTED"),
            debug_sample_tensor=_env_str("BYTEPS_DEBUG_SAMPLE_TENSOR", ""),
            enable_async=_env_bool("BYTEPS_ENABLE_ASYNC"),
            hierarchical=_env_bool("BYTEPS_HIERARCHICAL"),
            num_server=_env_int("DMLC_NUM_SERVER", 1),
            use_hash_key=_env_bool("BYTEPS_USE_HASH_KEY"),
            server_addrs=_env_str("BYTEPS_SERVER_ADDRS", ""),
            server_enable_profile=_env_bool("BYTEPS_SERVER_ENABLE_PROFILE"),
            server_profile_output_path=_env_str(
                "BYTEPS_SERVER_PROFILE_OUTPUT_PATH", "server_profile.json"),
            server_key_to_profile=_env_opt_int(
                "BYTEPS_SERVER_KEY_TO_PROFILE"),
            retry_max_attempts=_env_int("BYTEPS_RETRY_MAX_ATTEMPTS", 3),
            retry_backoff_ms=_env_float("BYTEPS_RETRY_BACKOFF_MS", 50.0),
            retry_backoff_mult=_env_float("BYTEPS_RETRY_BACKOFF_MULT", 2.0),
            retry_jitter=_env_float("BYTEPS_RETRY_JITTER", 0.1),
            retry_deadline_ms=_env_float("BYTEPS_RETRY_DEADLINE_MS",
                                         15_000.0),
            retry_version_guard=_env_opt_bool("BYTEPS_RETRY_VERSION_GUARD"),
            heartbeat_interval_ms=_env_float("BYTEPS_HEARTBEAT_INTERVAL_MS",
                                             0.0),
            heartbeat_miss_threshold=_env_int(
                "BYTEPS_HEARTBEAT_MISS_THRESHOLD", 3),
            failover=_env_bool("BYTEPS_FAILOVER", True),
            wire_window=_env_int("BYTEPS_WIRE_WINDOW", 8),
            wire_fanout=_env_int("BYTEPS_WIRE_FANOUT", 16),
            compression=_env_str("BYTEPS_COMPRESSION", ""),
            compression_min_bytes=_env_int("BYTEPS_MIN_COMPRESS_BYTES",
                                           1024),
            compression_overrides=_env_str("BYTEPS_COMPRESSION_OVERRIDES",
                                           ""),
            compression_ratio=_env_float("BYTEPS_COMPRESSION_RATIO", 0.01),
            compression_seed=_env_int("BYTEPS_COMPRESSION_SEED", 0),
            compression_reply=_env_str("BYTEPS_COMPRESSION_REPLY", ""),
            trace_path=_env_str("BYTEPS_TRACE_PATH", ""),
            trace_buffer=_env_int("BYTEPS_TRACE_BUFFER", 100_000),
            metrics_port=_env_int("BYTEPS_METRICS_PORT", 0),
            trace_rpc=_env_opt_bool("BYTEPS_TRACE_RPC"),
            serve_port=_env_int("BYTEPS_SERVE_PORT", 9000),
            serve_slots=_env_int("BYTEPS_SERVE_SLOTS", 8),
            serve_max_seq=_env_int("BYTEPS_SERVE_MAX_SEQ", 0),
            serve_max_queue=_env_int("BYTEPS_SERVE_MAX_QUEUE", 64),
            serve_prefill_credits=_env_int(
                "BYTEPS_SERVE_PREFILL_CREDITS", 0),
            serve_temperature=_env_float("BYTEPS_SERVE_TEMPERATURE", 0.0),
            serve_top_k=_env_opt_int("BYTEPS_SERVE_TOP_K"),
            serve_top_p=_env_opt_float("BYTEPS_SERVE_TOP_P"),
            serve_eos_id=_env_opt_int("BYTEPS_SERVE_EOS_ID"),
            serve_model=_env_str("BYTEPS_SERVE_MODEL", ""),
            serve_checkpoint=_env_str("BYTEPS_SERVE_CHECKPOINT", ""),
            serve_chunk=_env_int("BYTEPS_SERVE_CHUNK", 0),
            serve_prefix_cache=_env_bool("BYTEPS_SERVE_PREFIX_CACHE"),
            serve_prefix_block=_env_opt_int("BYTEPS_SERVE_PREFIX_BLOCK"),
            serve_prefix_mb=_env_int("BYTEPS_SERVE_PREFIX_MB", 256),
            serve_paged=_env_bool("BYTEPS_SERVE_PAGED"),
            serve_block=_env_int("BYTEPS_SERVE_BLOCK", 16),
            serve_kv_mb=_env_int("BYTEPS_SERVE_KV_MB", 0),
            serve_kv_dtype=_env_str("BYTEPS_SERVE_KV_DTYPE", ""),
            serve_paged_kernel=_env_str("BYTEPS_SERVE_PAGED_KERNEL",
                                        "auto"),
            serve_spec=_env_bool("BYTEPS_SERVE_SPEC"),
            serve_spec_k=_env_int("BYTEPS_SERVE_SPEC_K", 4),
            serve_spec_ngram=_env_int("BYTEPS_SERVE_SPEC_NGRAM", 3),
            serve_tp=_env_int("BYTEPS_TP", 1),
            serve_client_timeout_ms=_env_float(
                "BYTEPS_SERVE_CLIENT_TIMEOUT_MS", 300_000.0),
            heartbeat_timeout_ms=_env_float("BYTEPS_HEARTBEAT_TIMEOUT_MS",
                                            1_000.0),
            router_port=_env_int("BYTEPS_ROUTER_PORT", 9100),
            router_replicas=_env_str("BYTEPS_ROUTER_REPLICAS", ""),
            router_credits=_env_int("BYTEPS_ROUTER_CREDITS", 16),
            router_affinity=_env_bool("BYTEPS_ROUTER_AFFINITY", True),
            router_affinity_block=_env_int(
                "BYTEPS_ROUTER_AFFINITY_BLOCK", 16),
            router_deadline_ms=_env_float(
                "BYTEPS_ROUTER_DEADLINE_MS", 60_000.0),
            router_stream_timeout_ms=_env_float(
                "BYTEPS_ROUTER_STREAM_TIMEOUT_MS", 30_000.0),
            router_heartbeat_ms=_env_float(
                "BYTEPS_ROUTER_HEARTBEAT_MS", 500.0),
            router_miss_threshold=_env_int(
                "BYTEPS_ROUTER_MISS_THRESHOLD", 3),
            router_weights_fp=_env_str("BYTEPS_ROUTER_WEIGHTS_FP", ""),
            router_peers=_env_str("BYTEPS_ROUTER_PEERS", ""),
            router_self=_env_str("BYTEPS_ROUTER_SELF", ""),
            router_epoch_timeout_ms=_env_float(
                "BYTEPS_ROUTER_EPOCH_TIMEOUT_MS", 500.0),
            router_tenant_weights=_env_str(
                "BYTEPS_ROUTER_TENANT_WEIGHTS", ""),
            router_roles=_env_str("BYTEPS_ROUTER_ROLES", ""),
            disagg=_env_bool("BYTEPS_DISAGG", True),
            autoscale=_env_bool("BYTEPS_AUTOSCALE"),
            autoscale_min=_env_int("BYTEPS_AUTOSCALE_MIN", 1),
            autoscale_max=_env_int("BYTEPS_AUTOSCALE_MAX", 4),
            autoscale_up=_env_float("BYTEPS_AUTOSCALE_UP", 0.8),
            autoscale_down=_env_float("BYTEPS_AUTOSCALE_DOWN", 0.3),
            autoscale_up_cooldown_ms=_env_float(
                "BYTEPS_AUTOSCALE_UP_COOLDOWN_MS", 5_000.0),
            autoscale_down_cooldown_ms=_env_float(
                "BYTEPS_AUTOSCALE_DOWN_COOLDOWN_MS", 15_000.0),
            autoscale_interval_ms=_env_float(
                "BYTEPS_AUTOSCALE_INTERVAL_MS", 1_000.0),
            autoscale_window_ms=_env_float(
                "BYTEPS_AUTOSCALE_WINDOW_MS", 5_000.0),
            autoscale_dry_run=_env_bool("BYTEPS_AUTOSCALE_DRY_RUN"),
            slo_default=_env_str("BYTEPS_SLO_DEFAULT", "standard"),
            slo_standard_deadline_ms=_env_float(
                "BYTEPS_SLO_STANDARD_DEADLINE_MS", 10_000.0),
            slo_best_effort_deadline_ms=_env_float(
                "BYTEPS_SLO_BEST_EFFORT_DEADLINE_MS", 1_000.0),
            slo_service_estimate_ms=_env_float(
                "BYTEPS_SLO_SERVICE_ESTIMATE_MS", 500.0),
            slo_borrow=_env_bool("BYTEPS_SLO_BORROW", True),
            disagg_ship_timeout_ms=_env_float(
                "BYTEPS_DISAGG_SHIP_TIMEOUT_MS", 10_000.0),
            disagg_ship_retries=_env_int("BYTEPS_DISAGG_SHIP_RETRIES", 2),
            disagg_parked_cap=_env_int("BYTEPS_DISAGG_PARKED_CAP", 32),
            transport=_env_str("BYTEPS_TRANSPORT", "auto"),
            transport_overrides=_env_str("BYTEPS_TRANSPORT_OVERRIDES", ""),
        )


    @property
    def wire_torch_dtype(self):
        """``BYTEPS_WIRE_DTYPE`` as a torch dtype (None = no cast)."""
        if not self.wire_dtype:
            return None
        import torch

        try:
            return {"bf16": torch.bfloat16,
                    "fp16": torch.float16}[self.wire_dtype]
        except KeyError:
            raise ValueError(f"BYTEPS_WIRE_DTYPE={self.wire_dtype!r}: "
                             f"'bf16', 'fp16' or unset") from None

    @property
    def effective_partition_bytes(self) -> int:
        """The partition bound aligned down to ``partition_align`` (the
        JAX package's rule, reference global.cc:96-103)."""
        if self.partition_align <= 1:
            return self.partition_bytes
        aligned = (self.partition_bytes
                   - self.partition_bytes % self.partition_align)
        return max(self.partition_align, aligned)

    @property
    def effective_credit(self) -> int:
        """Scheduling credit in bytes (reference scheduled_queue.cc:31-42):
        ``BYTEPS_SCHEDULING_CREDIT``, else ``partition_bytes *
        (group_size + 1)``."""
        if self.scheduling_credit > 0:
            return self.scheduling_credit
        return self.partition_bytes * (self.group_size + 1)


def check_observability(cfg: "Config", role: str) -> None:
    """Refuse the observability knobs the serve and router roles do not
    serve: the ``/metrics`` scrape (``BYTEPS_METRICS_PORT``), RPC trace
    ids (``BYTEPS_TRACE_RPC``) and the RPC spans ``BYTEPS_TRACE_PATH``
    turns on there — the port's PS-tier and observability slice (queue A
    item 10)."""
    knobs = [f"BYTEPS_METRICS_PORT={cfg.metrics_port}"
             if cfg.metrics_port else None,
             f"BYTEPS_TRACE_RPC={int(cfg.trace_rpc)}"
             if cfg.trace_rpc is not None else None,
             f"BYTEPS_TRACE_PATH={cfg.trace_path!r}"
             if cfg.trace_path else None]
    knobs = [k for k in knobs if k]
    if knobs:
        raise NotImplementedError(
            f"{', '.join(knobs)}: the {role} role has no metrics scrape "
            f"and no RPC trace spans in this port yet (queue A item 10, "
            f"the PS tier and observability export); unset them")


def check_transport(transport: Optional[str]) -> None:
    """Refuse a transport this port does not serve: only TCP is
    (``auto`` resolves to it — the port advertises no local
    rendezvous)."""
    t = (transport or "auto").strip()
    if t not in ("auto", "tcp"):
        raise NotImplementedError(
            f"transport {t!r} (BYTEPS_TRANSPORT) selects a Unix-socket or "
            f"shared-memory endpoint, which this port does not serve yet "
            f"(queue A item 10: the unix / shm transports); use 'auto' or "
            f"'tcp'")


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def reset_config() -> None:
    global _config
    _config = None
