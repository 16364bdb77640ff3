"""Typed runtime configuration — the port's subset of
``byteps_tpu/common/config.py``.

Only the knobs the ported slices read are carried over, under the same
``BYTEPS_*`` / ``DMLC_*`` environment names so one environment drives
either package: the logging pair ``common/logging.py`` needs, the
``BYTEPS_SERVE_*`` knobs ``serving/frontend.py:serve_from_env`` reads,
the ``BYTEPS_DISAGG_*`` knobs of the disaggregated KV ship, and the
worker knobs ``api.init``, ``training.Trainer`` and
``make_data_parallel_step`` read.  Knobs naming features the port does
not have yet (checkpoints, a multi-worker world, async PS, the Unix
socket and shared-memory transports) are still parsed, so that a
non-default value is refused loudly instead of ignored.
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

    # --- worker / training (api.py, training/) -------------------------
    num_worker: int = 1            # DMLC_NUM_WORKER; > 1 refused (later)
    local_rank: Optional[int] = None   # BYTEPS_LOCAL_RANK (launcher)
    local_size: Optional[int] = None   # BYTEPS_LOCAL_SIZE (launcher)
    partition_bytes: int = 4_096_000   # push_pull bucket bytes (world > 1)
    enable_async: bool = False     # async PS mode; refused (later slice)

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
    serve_checkpoint: str = ""    # not ported: refused when set
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

    # --- disaggregated prefill/decode (serving/disagg) -----------------
    disagg_ship_timeout_ms: float = 10_000.0  # per-block ack deadline
    disagg_ship_retries: int = 2   # digest-refusal resends per block
    disagg_parked_cap: int = 32    # parked unshipped KV entries kept

    # --- endpoint transport --------------------------------------------
    # "auto" and "tcp" are served over TCP (no Unix-socket / shm
    # rendezvous is advertised, so a JAX client's "auto" finds TCP);
    # "unix", "shm" and explicit "unix:/..." / "shm:/..." are refused
    transport: str = "auto"

    @staticmethod
    def from_env() -> "Config":
        return Config(
            log_level=_env_str("BYTEPS_LOG_LEVEL", "WARNING"),
            log_hide_time=_env_bool("BYTEPS_LOG_HIDE_TIME"),
            num_worker=_env_int("DMLC_NUM_WORKER", 1),
            local_rank=_env_opt_int("BYTEPS_LOCAL_RANK"),
            local_size=_env_opt_int("BYTEPS_LOCAL_SIZE"),
            partition_bytes=_env_int("BYTEPS_PARTITION_BYTES", 4_096_000),
            enable_async=_env_bool("BYTEPS_ENABLE_ASYNC"),
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
            disagg_ship_timeout_ms=_env_float(
                "BYTEPS_DISAGG_SHIP_TIMEOUT_MS", 10_000.0),
            disagg_ship_retries=_env_int("BYTEPS_DISAGG_SHIP_RETRIES", 2),
            disagg_parked_cap=_env_int("BYTEPS_DISAGG_PARKED_CAP", 32),
            transport=_env_str("BYTEPS_TRANSPORT", "auto"),
        )


def check_transport(transport: Optional[str]) -> None:
    """Refuse a transport this port does not serve: only TCP is
    (``auto`` resolves to it — the port advertises no local
    rendezvous)."""
    t = (transport or "auto").strip()
    if t not in ("auto", "tcp"):
        raise NotImplementedError(
            f"transport {t!r} (BYTEPS_TRANSPORT) selects a Unix-socket or "
            f"shared-memory endpoint, which this port does not serve; use "
            f"'auto' or 'tcp'")


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def reset_config() -> None:
    global _config
    _config = None
