"""Error-feedback compression as a gradient transform — the port of
``byteps_tpu/compression/error_feedback.py``.

``error_feedback_compress(scheme)`` generalizes
``ops/quantization.error_feedback_quantize_gradients`` to every registry
scheme: per leaf, ``corrected = g + e``; the *compressed-then-
decompressed* value is what flows on to the communication/optimizer
chain (so every worker contributes low-precision payloads), and ``e' =
corrected - deq`` carries the unsent part to the next step — the fix
that makes biased compressors (signSGD, top-k) converge (Karimireddy et
al., ICML'19; Lin et al., ICLR'18).  Each leaf is rounded whole (onebit's
scale is the leaf's mean |x|), never a bucket of leaves.

The state is one fp32 residual a leaf plus a step count
(``EFCompressState``); ``state_dict()`` / ``load_state_dict()`` carry it
through a checkpoint, so a resumed run continues the carry instead of
dropping it.  Seeded schemes (randomk, dithered int8) take leaf ``i``'s
seed at count ``c`` from ``derive_seed(seed, str(i), c)``: a re-executed
step from the same state replays the same coordinates, and the rank is
not part of it, so every rank draws the same mask and dither (the JAX
package's replicated key).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from ..ops.quantization import GradientTransform, leaves, map_ef_pairs
from .registry import Scheme, derive_seed, get_scheme

__all__ = ["EFCompressState", "ErrorFeedback", "error_feedback_compress",
           "compression_roundtrip"]


@dataclasses.dataclass
class EFCompressState:
    error: List[torch.Tensor]  # fp32 residuals, one a leaf
    count: int = 0             # steps taken -> per-step seeds

    def state_dict(self) -> dict:
        return {"error": list(self.error), "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        if len(sd["error"]) != len(self.error):
            raise ValueError(f"{len(sd['error'])} residuals in the state, "
                             f"{len(self.error)} leaves here")
        for e, s in zip(self.error, sd["error"]):
            e.copy_(s)
        self.count = int(sd["count"])


def _config_defaults(ratio, seed):
    if ratio is None or seed is None:
        from ..common.config import get_config

        cfg = get_config()
        ratio = cfg.compression_ratio if ratio is None else ratio
        seed = cfg.compression_seed if seed is None else seed
    return ratio, seed


class ErrorFeedback:
    """The transform :func:`error_feedback_compress` returns: ``init`` and
    ``update`` as every gradient transform, and ``leaf``, which rounds one
    leaf, for callers that meet the leaves one at a time (the
    DistributedOptimizer's gradient hooks)."""

    def __init__(self, scheme: Scheme, ratio: float, seed: int):
        self.scheme, self.ratio, self.seed = scheme, ratio, seed

    def init(self, params) -> EFCompressState:
        return EFCompressState(
            [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in leaves(params)], 0)

    def leaf(self, i: int, g: torch.Tensor, e: torch.Tensor,
             count: int) -> tuple:
        """``(deq in g's dtype, e')`` for leaf ``i`` at step ``count``."""
        corrected = g.float() + e
        seed = (derive_seed(self.seed, str(i), count)
                if self.scheme.seeded else None)
        deq = self.scheme.roundtrip(corrected, seed=seed,
                                    ratio=self.ratio).float()
        return deq.to(g.dtype), torch.sub(corrected, deq, out=corrected)

    def update(self, updates, state: EFCompressState) -> tuple:
        index = iter(range(len(state.error)))   # the leaves, in order
        new_updates, new_error = map_ef_pairs(
            lambda g, e: self.leaf(next(index), g, e, state.count),
            updates, state.error)
        return new_updates, EFCompressState(new_error, state.count + 1)


def error_feedback_compress(scheme: Union[str, Scheme],
                            ratio: Optional[float] = None,
                            seed: Optional[int] = None) -> ErrorFeedback:
    """Gradient transform: compress incoming gradients under ``scheme``
    (through the dequantized payload) with error feedback.  Apply it
    BEFORE the communication — compression happens after local
    aggregation, before the wire.  ``ratio`` / ``seed`` default from
    config (``BYTEPS_COMPRESSION_RATIO`` / ``BYTEPS_COMPRESSION_SEED``)."""
    sch = get_scheme(scheme) if isinstance(scheme, str) else scheme
    return ErrorFeedback(sch, *_config_defaults(ratio, seed))


def compression_roundtrip(scheme: Union[str, Scheme],
                          ratio: Optional[float] = None
                          ) -> GradientTransform:
    """Stateless compress->decompress per gradient, NO error feedback —
    the world==1 mirror of what an unbiased cast scheme does to each
    contribution on a multi-worker wire (cast in, reduce, cast out), so
    single- and multi-process runs see the same numerics."""
    sch = get_scheme(scheme) if isinstance(scheme, str) else scheme
    ratio, _ = _config_defaults(ratio, 0)

    def update_fn(updates, state):
        return ([(u[0], sch.roundtrip(u[1], ratio=ratio))
                 if isinstance(u, tuple) else sch.roundtrip(u, ratio=ratio)
                 for u in updates], state)

    return GradientTransform(lambda params: None, update_fn)

