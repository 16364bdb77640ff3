"""Gradient wire-compression subsystem — the port of
``byteps_tpu/compression``: pluggable error-feedback compressors at the
"compress after local aggregation, before the wire" point that BytePS's
push/pull architecture exposes and its protocol enum reserved but never
implemented (``kCompressedPushPull``, reference common.h:212-216).

Layers:

  * ``registry``       — scheme table (none/bf16/fp16/int8/topk/randomk/
                         onebit), torch roundtrips + numpy wire codecs,
                         per-tensor ``CompressionPolicy``;
  * ``error_feedback`` — the error-feedback gradient transform (an fp32
                         residual a leaf, checkpointable);
  * ``wire``           — versioned blob framing + ``WireCompressor``
                         (client-side EF with post-ack commit);
  * ``stats``          — wire_bytes_sent/saved counters + run-end
                         summary.
"""

from .error_feedback import (EFCompressState, ErrorFeedback,  # noqa: F401
                             compression_roundtrip, error_feedback_compress)
from .registry import (REPLY_SAFE, SCHEMES, CompressionPolicy,  # noqa: F401
                       Scheme, derive_seed, get_scheme, register_scheme)
from .stats import (CompressionStats, get_compression_stats,  # noqa: F401
                    reset_compression_stats)
from .wire import (WIRE_TAG, WireBlob, WireCompressor, decode_blob,  # noqa: F401
                   encode_blob, maybe_compress_reply)
