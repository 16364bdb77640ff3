"""Token sampling — the port of ``byteps_tpu/inference.py:192``
``sample_logits`` (temperature, top-k, top-p), plus the port's own
sampling-noise chain — and ``truncated_draft`` (``:578``), the LayerSkip
self-draft that ``lm_loss_fn(early_exit=...)`` trains.

JAX draws from ``jax.random`` keys; PyTorch's generators give other
numbers from the same seed, so sampled streams of the two packages
differ while greedy streams agree token for token.  The port's chain is
a pure function of ``(seed, k)``: the ``k``-th token of a request with
seed ``seed`` is drawn with Gumbel noise from a CPU ``torch.Generator``
seeded from ``(seed, k)`` (:func:`token_generator`).  So a request's
sampled stream does not depend on batch composition, on the device, or
on preemption and resume — resuming after ``k`` tokens needs only ``k``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import torch
from torch import nn

from .models.transformer import Transformer

__all__ = ["sample_logits", "token_generator", "truncated_draft"]


def token_generator(seed: int, k: int) -> torch.Generator:
    """CPU generator for the ``k``-th emitted token of a request seeded
    ``seed`` (a hash of the pair, so nearby seeds do not overlap)."""
    h = hashlib.blake2b(f"{int(seed)}:{int(k)}".encode(), digest_size=8)
    g = torch.Generator(device="cpu")
    g.manual_seed(int.from_bytes(h.digest(), "little") >> 1)
    return g


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Sample token ids from ``logits [B, vocab]``.

    ``temperature == 0`` is greedy argmax (first index on ties, as
    ``jnp.argmax``).  ``top_k`` keeps the k highest logits; ``top_p``
    keeps the smallest prefix of the sorted distribution with
    cumulative probability >= top_p (the highest-probability token is
    always kept); k first, then p, with the JAX version's tie rule
    (mask by value threshold).  Sampling is Gumbel-max with noise drawn
    on the CPU from ``generator`` and moved to the logits' device, so a
    generator state gives the same token on every device."""
    if temperature == 0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    V = logits.shape[-1]
    if top_k is not None and top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose exclusive cumulative mass is < top_p
        keep_sorted = (cum - probs) < top_p
        kept = sorted_logits.masked_fill(~keep_sorted, float("inf"))
        threshold = kept.min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u)).to(logits.device)
    return torch.argmax(logits + gumbel, dim=-1)


def truncated_draft(model: Transformer, num_layers: int) -> Transformer:
    """LayerSkip-style self-draft: a ``Transformer`` whose config has
    ``num_layers`` and whose embeddings, first ``num_layers`` blocks,
    final norm and head are the target's own modules — the same
    ``nn.Parameter`` objects, so nothing is copied and a gradient through
    the draft reaches the target's weights (the JAX version returns the
    same arrays in a filtered tree)."""
    cfg = model.cfg
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(
            f"draft num_layers {num_layers} not in [1, {cfg.num_layers}]")
    # built on the meta device (no memory), then given the target's modules
    draft = Transformer(dataclasses.replace(cfg, num_layers=num_layers),
                        device="meta")
    draft.embed = model.embed
    if cfg.pos_emb == "learned":
        draft.pos = model.pos
    draft.blocks = nn.ModuleList(model.blocks[:num_layers])
    draft.ln_f = model.ln_f
    if not cfg.tie_embeddings:
        draft.lm_head = model.lm_head
    return draft
