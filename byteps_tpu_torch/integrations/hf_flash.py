"""Route HuggingFace torch BERT self-attention through the port's flash
kernels — the port of ``byteps_tpu/integrations/hf_flash.py``, which
does this for HF's Flax BERT.

Inside :func:`flash_attention_for_hf_bert`, every ``BertSelfAttention``
(and ``BertSdpaSelfAttention``, where the installed ``transformers`` has
that class) keeps its own ``query`` / ``key`` / ``value`` projections and
parameters, and computes attention with ``ops.flash_attention`` — a stock
HF checkpoint trains through the kernels with no weight surgery.

The padding mask rides the kernels' segment ids (non-causal): pads see
only pads, so valid positions equal HF's masked softmax, and padding
positions differ (compare valid positions and the CLS logits).  HF hands
the attention module an expanded mask, not the ``[B, T]`` one: ``None``
when nothing is padded, a 2-D ``[B, T]`` mask, or a 4-D ``[B, 1, T|1,
T]`` one — boolean (True = attend) or additive (0 = attend).  The key
validity is read back from it; a mask whose query rows differ is not a
padding mask.

Calls the kernels do not cover take the stock implementation, as in the
JAX module: ``output_attentions``, a head mask, cross-attention, a
decoder or a cache, attention-probability dropout in training mode, a
relative position embedding, and a mask that is not a key mask.  The
context yields an :class:`HFFlashCounts` that counts covered and
uncovered calls (by reason).  The class methods are restored on exit, an
exception included.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import inspect
from typing import Dict, Optional

import torch

__all__ = ["flash_attention_for_hf_bert", "HFFlashCounts"]

# the forward parameters of the BertSelfAttention classes this module
# reads: transformers 4.x (hidden_states, attention_mask, head_mask,
# encoder_hidden_states, past_key_values, output_attentions,
# cache_position) and 5.x (hidden_states, attention_mask,
# past_key_values, **kwargs)
_KNOWN_PARAMS = frozenset((
    "self", "hidden_states", "attention_mask", "head_mask",
    "encoder_hidden_states", "past_key_values", "past_key_value",
    "output_attentions", "cache_position"))


@dataclasses.dataclass
class HFFlashCounts:
    """Self-attention calls inside one context: ``covered`` through the
    flash kernels, ``uncovered`` through the stock implementation, by
    reason."""

    covered: int = 0
    uncovered: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def uncovered_total(self) -> int:
        return sum(self.uncovered.values())


def _key_mask(mask, B: int, T: int):
    """``(True, segment ids [B, T] int32 or None)`` from HF's mask, or
    ``(False, None)`` when it is not a key mask over these ``T`` keys."""
    if mask is None:
        return True, None
    if not isinstance(mask, torch.Tensor) or mask.shape[-1] != T:
        return False, None
    if mask.ndim == 2:
        keep = mask if mask.dtype == torch.bool else mask != 0
    elif mask.ndim == 4 and mask.shape[1] == 1:
        keep = mask if mask.dtype == torch.bool else mask == 0
        if not bool((keep == keep[:, :, :1]).all()):
            return False, None            # query rows differ
        keep = keep[:, 0, 0]
    else:
        return False, None
    return True, keep.expand(B, T).to(torch.int32)


def _uncovered(module, args: dict) -> Optional[str]:
    """Why the flash kernels do not cover this call, or None."""
    if args.get("output_attentions"):
        return "output_attentions"
    if args.get("head_mask") is not None:
        return "head_mask"
    if args.get("encoder_hidden_states") is not None:
        return "cross_attention"
    if (getattr(module, "is_decoder", False)
            or getattr(module, "is_causal", False)
            or args.get("past_key_values") is not None
            or args.get("past_key_value") is not None):
        return "decoder_or_cache"
    if module.training and module.dropout.p > 0.0:
        return "dropout"
    if getattr(module, "position_embedding_type", "absolute") != "absolute":
        return "position_embedding"
    return None


def _patched(orig, counts: HFFlashCounts, masks: dict):
    sig = inspect.signature(orig)
    unknown = [n for n, p in sig.parameters.items()
               if n not in _KNOWN_PARAMS and p.kind != p.VAR_KEYWORD]
    if unknown:
        import transformers

        raise NotImplementedError(
            f"transformers {transformers.__version__}: "
            f"{orig.__qualname__} takes {unknown}, which "
            f"flash_attention_for_hf_bert does not know")

    from ..ops.flash_attention import flash_attention

    def forward(self, *a, **kw):
        try:
            bound = sig.bind(self, *a, **kw).arguments
        except TypeError:
            bound = None
        if bound is None:
            why = "arguments"
        else:
            args = dict(bound)
            for n, p in sig.parameters.items():
                if p.kind == p.VAR_KEYWORD:
                    args.update(args.pop(n, {}))
            why = _uncovered(self, args)
        if why is None:
            hs = args["hidden_states"]
            B, T, _ = hs.shape
            mask = args.get("attention_mask")
            # one read of the mask a forward: every layer gets the same one
            if "key" not in masks or masks["mask"] is not mask:
                masks.update(mask=mask, key=_key_mask(mask, B, T))
            ok, seg = masks["key"]
            if not ok:
                why = "mask"
        if why is not None:
            counts.uncovered[why] += 1
            return orig(self, *a, **kw)
        counts.covered += 1
        H, D = self.num_attention_heads, self.attention_head_size
        q = self.query(hs).view(B, T, H, D)
        k = self.key(hs).view(B, T, H, D)
        v = self.value(hs).view(B, T, H, D)
        out = flash_attention(q, k, v, causal=False,
                              scale=getattr(self, "scaling", None),
                              segment_ids=seg)
        return out.reshape(B, T, H * D), None

    return forward


@contextlib.contextmanager
def flash_attention_for_hf_bert():
    """Context manager: inside it, every HF torch BERT self-attention (and
    models sharing the classes) computes through the flash kernels.
    Usage::

        with flash_attention_for_hf_bert() as counts:
            logits = model(tokens, attention_mask=mask).logits
        assert counts.uncovered_total == 0

    The JAX context's ``block_q`` / ``block_k`` / ``interpret`` are Pallas
    switches the kernels do not have."""
    from transformers.models.bert import modeling_bert as m

    classes = [c for c in (getattr(m, "BertSelfAttention", None),
                           getattr(m, "BertSdpaSelfAttention", None))
               if c is not None and "forward" in vars(c)]
    counts = HFFlashCounts()
    masks: dict = {}
    orig = {c: vars(c)["forward"] for c in classes}
    patched = {c: _patched(f, counts, masks) for c, f in orig.items()}
    try:
        for c, f in patched.items():
            c.forward = f
        yield counts
    finally:
        for c, f in orig.items():
            c.forward = f
        masks.clear()
