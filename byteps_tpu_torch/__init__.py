"""byteps_tpu_torch — the PyTorch/CUDA port of ``byteps_tpu``.

A second package beside the JAX reference: it imports ``torch`` and
never ``jax`` or ``byteps_tpu``, keeping its own copies of what it needs.
Ported so far: paged continuous-batching serving (``serving/``), its
decode attention a hand-written CUDA kernel for Hopper
(``ops/paged_attention.py``, ``csrc/paged_attention.cu``); and the
single-process LM training step (``training/``, ``api.py``) with flash
attention's forward and backward as hand-written kernels
(``ops/flash_attention.py``, ``csrc/flash_attention.cu``) and the fused
LM-head cross-entropy (``ops/fused_cross_entropy.py``); and cached
generation (``inference.generate``) with its decode attention and int8
weight-only product as hand-written kernels (``ops/decode_attention.py``,
``ops/quant_dot.py``); and the BytePS core beyond one worker: the
eager push_pull engine (``engine/dispatcher.py``) and collectives on
``torch.distributed`` (``parallel/``) behind the Horovod API
(``api.py``), the ``DistributedOptimizer`` and the data-parallel step
(``training/``), one process a worker; and the rest of the worker's
training path: the compression registry with error feedback
(``compression/``), checkpoints, callbacks and the delayed-gradient
overlap step (``training/``); and the async parameter-server tier over
TCP: the native host reducer (``native/``, ``csrc/byteps_native.cc``),
the PS shard and its client (``engine/ps_server.py``, ``engine/wire.py``)
and the async stores and worker (``engine/async_ps.py``) behind
``Trainer(async_mode=True)``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
