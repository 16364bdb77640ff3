"""Build and load the port's hand-written CUDA kernels, and the dispatch
rule their wrappers share (:func:`on_cuda`, :func:`wide_dtype`).

Every kernel source under ``byteps_tpu_torch/csrc/`` has a plain C
interface.  At first use it is compiled with ``nvcc`` for ``sm_90a``
into ``build/byteps_tpu_torch/lib<name>-<hash>.so`` (gitignored; the
hash covers the source and the flags, so an edited source is rebuilt)
and loaded with ``ctypes``.  :func:`build` starts one ``nvcc`` per
source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

__all__ = ["build", "load", "build_logs", "on_cuda", "wide_dtype",
           "sm_count", "CSRC"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
              / "byteps_tpu_torch")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_sms: Dict[torch.device, int] = {}
build_logs: Dict[str, str] = {}  # nvcc's output per kernel (ptxas report)


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and "
            "PATH): the port's kernels are built at first use on a machine "
            "with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"lib{name}-{tag[:12]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for every name not built yet, one
    ``nvcc`` process per source, started together; returns each
    library's path.  Libraries are written under a temporary name and
    renamed, so a concurrent build never loads a partial file."""
    out = {n: _target(n) for n in names}
    with _lock:
        todo = {n: so for n, so in out.items() if not so.exists()}
        if not todo:
            return out
        nvcc = _nvcc()
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, so in todo.items():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            build_logs[n] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) building "
                              f"{CSRC / f'{n}.cu'}:\n{build_logs[n]}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _libs[name] = lib
    return lib


def on_cuda(what: str, *tensors) -> bool:
    """False when every tensor lies on the CPU (the plain version runs),
    True when all lie on one CUDA device (the kernel runs); anything
    else raises.  ``None`` entries are skipped."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what} needs every tensor on one CUDA device "
                         f"(or all on the CPU), got {devices}")
    return True


def wide_dtype(*tensors) -> torch.dtype:
    """The accumulation dtype of the plain versions: fp32, or fp64 when
    an input is fp64 (so ``torch.autograd.gradcheck`` can run them)."""
    out = torch.float32
    for t in tensors:
        out = torch.promote_types(out, t.dtype)
    return out


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per device):
    the wrappers size their grids to fill the card."""
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n
