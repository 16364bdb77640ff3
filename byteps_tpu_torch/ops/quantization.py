"""Int8 gradient quantization with error feedback — the port of
``byteps_tpu/ops/quantization.py`` (plain torch; the JAX module is plain
``jnp``, no kernel).

Two surfaces:
  * ``quantize`` / ``dequantize`` — symmetric int8 with one fp32 scale
    per tensor (absmax / 127; round half to even; clip to ±127).
  * ``error_feedback_quantize_gradients`` — a gradient transform over a
    list of gradients: ``q = Q(g + e); e' = (g + e) - dQ(q)``; the
    *quantized-then-dequantized* gradient is what gets push_pulled, so
    every worker contributes identical low-precision payloads.

A gradient transform is the port's rendering of an optax
``GradientTransformation`` (compression/error_feedback.py): ``init(params)
-> state`` and ``update(grads, state) -> (grads, state)`` over a list of
tensors (or ``(name, tensor)`` pairs, whose names ride along), in the
order the JAX package flattens its pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Sequence

import torch

__all__ = ["quantize", "dequantize", "EFState", "GradientTransform",
           "leaves", "map_ef_pairs", "error_feedback_quantize_gradients"]


class GradientTransform(NamedTuple):
    """``init(params) -> state``; ``update(grads, state) -> (grads,
    state)`` (optax's ``GradientTransformation`` shape)."""

    init: Callable
    update: Callable


def quantize(x: torch.Tensor) -> tuple:
    """Symmetric int8 quantization: returns (q int8, scale fp32 scalar)."""
    xf = x.float()
    absmax = xf.abs().max()
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.float()


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


@dataclasses.dataclass
class EFState:
    error: List[torch.Tensor]  # fp32 residuals, one a gradient


def leaves(seq: Sequence) -> List[torch.Tensor]:
    """The tensors of a list of tensors or ``(name, tensor)`` pairs."""
    return [g[1] if isinstance(g, tuple) else g for g in seq]


def map_ef_pairs(fn, updates: Sequence, error: Sequence) -> tuple:
    """Apply ``fn(g, e) -> (new_g, new_e)`` over a gradient list and its
    matching residual list; returns the two result lists (``(name, g)``
    pairs keep their names)."""
    grads = leaves(updates)
    if len(error) != len(grads):
        raise ValueError(
            f"gradient/error list mismatch: {len(grads)} vs {len(error)}"
            " — was the state initialized for these params?")
    outs = [fn(g, e) for g, e in zip(grads, error)]
    new_g = [(u[0], o[0]) if isinstance(u, tuple) else o[0]
             for u, o in zip(updates, outs)]
    return new_g, [o[1] for o in outs]


def error_feedback_quantize_gradients() -> GradientTransform:
    """Gradient transform: quantize incoming gradients to int8 (through a
    dequantized payload) with error feedback.  Apply it BEFORE the
    push_pull of the gradients."""

    def init_fn(params):
        return EFState([torch.zeros_like(p, dtype=torch.float32)
                        for p in leaves(params)])

    def update_fn(updates, state):
        def q1(g, e):
            corrected = g.float() + e
            qv, scale = quantize(corrected)
            deq = dequantize(qv, scale)
            return deq.to(g.dtype), corrected - deq

        new_updates, new_error = map_ef_pairs(q1, updates, state.error)
        return new_updates, EFState(new_error)

    return GradientTransform(init_fn, update_fn)
