"""ctypes loader for the port's native host library, built at first use
— the port of ``byteps_tpu/native/reducer.py``.

API:
  available() -> bool
  load() -> ctypes.CDLL          # builds if needed; raises if it cannot
  sum_into(dst, src)             # dst += src elementwise, OpenMP-parallel
  key_to_shard(key, n) -> int    # reference global.cc:305-334 hash
  omp_max_threads() -> int

The library is the port's own copy of the C++ source,
``byteps_tpu_torch/csrc/byteps_native.cc``, compiled with the host
compiler into ``build/byteps_tpu_torch/libbyteps_native-<hash>.so``
(gitignored; the hash covers the source, the compiler and the flags, so
an edited source is rebuilt), as ``ops/_build.py`` builds the CUDA
kernels.  No ``-march=native``: a library built on one host may be
loaded on another.  The compilers are tried in turn — ``$CXX``, ``g++``,
``/usr/bin/g++``, ``c++``, ``clang++`` — with ``-fopenmp``; a toolchain
without OpenMP (one without ``libgomp``) builds the same loops serially,
said in a warning and in :func:`omp_max_threads` (1).  The sums are
elementwise, so their bits do not depend on the thread count.

Unlike the JAX loader, a failed build is not quietly replaced by numpy:
:func:`load` raises, and ``AsyncParameterServer(use_native=True)`` with
it.  ``use_native=False`` is the explicit numpy path.

bfloat16 has no numpy dtype in the port, so bf16 tensors are held as
``torch.Tensor`` (CPU); :func:`sum_into` takes either a numpy array or
a CPU tensor and sums bf16 through ``bps_sum_bf16`` on its storage.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

__all__ = ["available", "load", "sum_into", "key_to_shard",
           "omp_max_threads", "library_path"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "byteps_native.cc"
_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
              / "byteps_tpu_torch")
_FLAGS = ["-O3", "-fopenmp", "-pthread", "-fPIC", "-std=c++17", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
built_with = ""   # the compiler and flags of the loaded library

_SUM_FN = {
    np.dtype(np.float32): "bps_sum_f32",
    np.dtype(np.float64): "bps_sum_f64",
    np.dtype(np.float16): "bps_sum_f16",
    np.dtype(np.int32): "bps_sum_i32",
    np.dtype(np.int64): "bps_sum_i64",
}


def _compilers() -> List[str]:
    env = os.environ.get("CXX")
    cands = ([env] if env else []) + ["g++", "/usr/bin/g++", "c++",
                                      "clang++"]
    return list(dict.fromkeys(cands))


def library_path(cxx: Optional[str] = None,
                 flags: Optional[List[str]] = None) -> Path:
    """Where this source, compiler and flag set builds to."""
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(
        [cxx or _compilers()[0], *(_FLAGS if flags is None else flags)]
    ).encode()).hexdigest()
    return _BUILD_DIR / f"libbyteps_native-{tag[:12]}.so"


def _compile(cxx: str, flags: List[str], so: Path) -> Optional[str]:
    """One compile under a temporary name, renamed when it succeeds (so a
    concurrent build never loads a partial file); the error, or None."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [cxx, *flags, "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        return (f"({proc.returncode}) {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return None


def _built() -> Path:
    """A built library: the first compiler that builds it with OpenMP,
    else the first that builds it serially; raises when none does."""
    global built_with
    serial = [f for f in _FLAGS if f != "-fopenmp"]
    errors = []
    for flags in (_FLAGS, serial):
        for cxx in _compilers():
            so = library_path(cxx, flags)
            built_with = " ".join([cxx, *flags])
            if so.exists():
                return so
            err = _compile(cxx, flags, so)
            if err is None:
                if flags is serial:
                    from ..common import logging as bps_log

                    bps_log.warning(
                        "native reducer built without OpenMP (no compiler "
                        "here builds with -fopenmp): the sums run on one "
                        "thread.  %s", errors[0] if errors else "")
                return so
            errors.append(err)
    raise RuntimeError("native reducer build failed: " + "\n".join(errors))


def load() -> ctypes.CDLL:
    """The loaded library, built on first use; raises ``RuntimeError``
    when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_built()))
        for name in (*_SUM_FN.values(), "bps_sum_bf16"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int64]
            getattr(lib, name).restype = None
        lib.bps_key_to_shard.argtypes = [ctypes.c_uint64, ctypes.c_int64]
        lib.bps_key_to_shard.restype = ctypes.c_int64
        lib.bps_omp_max_threads.restype = ctypes.c_int
        lib.bps_abi_version.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except (RuntimeError, OSError):
        return False


def sum_into(dst, src) -> None:
    """``dst += src`` through the library (reference CpuReducer::sum,
    cpu_reducer.cc:41-155).  ``dst`` is a numpy array or a CPU
    ``torch.Tensor``; ``src`` is cast to its dtype first.  A dtype the
    library has no loop for (or a non-contiguous ``dst``) adds in numpy
    or torch, as the JAX loader does."""
    lib = load()
    if isinstance(dst, torch.Tensor):
        if dst.dtype != torch.bfloat16:
            sum_into(dst.numpy(), src.numpy()
                     if isinstance(src, torch.Tensor) else src)
            return
        s = (src if isinstance(src, torch.Tensor)
             else torch.from_numpy(np.asarray(src)))
        s = s.to(torch.bfloat16).contiguous()
        if not dst.is_contiguous():
            dst += s
            return
        lib.bps_sum_bf16(ctypes.c_void_p(dst.data_ptr()),
                         ctypes.c_void_p(s.data_ptr()),
                         ctypes.c_int64(dst.numel()))
        return
    src = np.ascontiguousarray(src, dtype=dst.dtype)
    fn_name = _SUM_FN.get(dst.dtype)
    if fn_name is None or not dst.flags.c_contiguous:
        dst += src
        return
    getattr(lib, fn_name)(dst.ctypes.data_as(ctypes.c_void_p),
                          src.ctypes.data_as(ctypes.c_void_p),
                          ctypes.c_int64(dst.size))


def key_to_shard(key: int, num_shards: int) -> int:
    return int(load().bps_key_to_shard(key, num_shards))


def omp_max_threads() -> int:
    return int(load().bps_omp_max_threads())
