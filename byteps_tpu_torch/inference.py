"""Token sampling — the port of ``byteps_tpu/inference.py:192``
``sample_logits`` (temperature, top-k, top-p), plus the port's own
sampling-noise chain.

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

import hashlib
from typing import Optional

import torch

__all__ = ["sample_logits", "token_generator"]


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
