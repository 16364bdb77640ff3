"""byteps_tpu_torch.native — ctypes bindings to the port's C++ host
library (``csrc/byteps_native.cc``): the async-PS server's summation
loop (the reference's cpu_reducer), fp16 / bf16 software arithmetic and
the key->shard hash.  Compiled on demand with the host compiler."""

from . import reducer  # noqa: F401

__all__ = ["reducer"]
