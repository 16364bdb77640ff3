"""Shared helper for the HF weight converters."""

from __future__ import annotations

import torch

__all__ = ["to_float32"]


def to_float32(t) -> torch.Tensor:
    """A torch tensor (or array-like) -> a detached fp32 copy on the
    tensor's own device: the converters' common dtype (bf16 and fp16
    weights upcast), owned by the returned state dict rather than shared
    with the HF model's parameters."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32, copy=True)
    return torch.tensor(t, dtype=torch.float32)
