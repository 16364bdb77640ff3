"""Hand-written kernels and their plain PyTorch versions, one module each:
``paged_attention``, ``flash_attention``, ``fused_cross_entropy``,
``decode_attention`` and ``quant_dot``.  ``fused_linear_cross_entropy``
is re-exported here; the other modules are imported as modules (three
share their function's name)."""

from .fused_cross_entropy import fused_linear_cross_entropy

__all__ = ["fused_linear_cross_entropy"]
