"""Hand-written kernels and their plain PyTorch versions, one module each:
``paged_attention``, ``flash_attention`` and ``fused_cross_entropy``
(whose entry point is re-exported here; the other two modules share
their function's name, so they are imported as modules)."""

from .fused_cross_entropy import fused_linear_cross_entropy

__all__ = ["fused_linear_cross_entropy"]
