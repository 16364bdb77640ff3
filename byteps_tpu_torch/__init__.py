"""byteps_tpu_torch — the PyTorch/CUDA port of ``byteps_tpu``.

A second package beside the JAX reference: it imports ``torch`` and
never ``jax`` or ``byteps_tpu``, keeping its own copies of what it needs.
This slice ports paged continuous-batching serving (``serving/``) with
its decode attention as a hand-written CUDA kernel for Hopper
(``ops/paged_attention.py``, ``csrc/paged_attention.cu``).  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
