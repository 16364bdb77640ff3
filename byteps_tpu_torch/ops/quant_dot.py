"""The int8 weight-only product ``y = (x . W_int8^T) * scale (+ bias)``
as a hand-written Hopper kernel.

Replaces the TPU kernel ``scripts/dot_probe.py:27`` ``quant_dot_kernel``
(its ``pallas_call`` at ``:35``): the product that ``QuantDense``
(``byteps_tpu/models/transformer.py:218-252``) computes for every
projection of a tree quantized by ``inference.quantize_params``.  The
kernel is CUDA C++ (``byteps_tpu_torch/csrc/quant_dot.cu``), compiled
with ``nvcc`` for ``sm_90a`` at first use (``ops/_build.py``) and bound
here with ``ctypes``.  Torch has no bf16 x int8 product; without the
kernel the weights would be widened to bf16 on every call.

What it computes: ``x [..., K]`` in the compute dtype (fp32 or bf16),
``w [N, K]`` int8 (``nn.Linear``'s ``[out, in]``), ``scale [N]`` fp32,
an optional ``bias [N]``; ``[..., N]`` in ``out_dtype`` (the compute
dtype, or fp32 for a head that accumulates in fp32).  Rounding as
``QuantDense`` (not as the probe kernel, which scales the fp32 sum and
rounds once; the two differ by at most one bf16 ulp): the product is
summed in fp32 and rounded to the compute dtype, the scale is rounded to
``out_dtype`` and multiplies it there, the bias is added in
``out_dtype``.

What bounds it: at decode (few rows) the int8 weight bytes over HBM, at
prefill the bf16 tensor-core rate.  The design (the ``mma.sync`` tile
loop of the fused CE kernels, the int8 tile dequantized to bf16 as it is
staged, split-K when the output tiles would not fill the card) is set
out in the CUDA source.

Beside the kernel:

* :func:`quant_linear_reference` — the plain PyTorch version (fp32 sums
  of the exact products, then ``QuantDense``'s rounding points);
* :func:`quantize_weight` — symmetric per-output-channel int8 of a
  ``[N, K]`` weight (``inference.quantize_params``'s rule);
* :func:`quant_linear` — the wrapper: CPU tensors take the plain version,
  CUDA tensors launch the kernel or raise;
* ``launches`` / ``plain_calls`` counters.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["quant_linear", "quant_linear_reference", "quantize_weight",
           "quant_flops", "build", "BLOCK", "BK"]

launches = 0
plain_calls = 0

BLOCK = 128  # rows and columns of a kernel tile
BK = 32      # depth of one K step
_lib = None


def build():
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    return _build.build(["quant_dot"])["quant_dot"]


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("quant_dot")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bps_quant_dot.argtypes = [p] * 6 + [i] * 7 + [p]
        lib.bps_quant_dot.restype = i
        _lib = lib
    return _lib


@torch.no_grad()
def quantize_weight(w: torch.Tensor):
    """``(int8 [N, K], fp32 scale [N])``: per output channel, ``scale =
    absmax / 127`` over the contraction (input) dim, 1 where the row is
    all zeros; ``q = clip(round(w / scale), -127, 127)``, rounding half
    to even — JAX ``quantize_params``'s rule, bit for bit."""
    wf = w.detach().to(torch.float32)
    absmax = wf.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quant_flops(M: int, N: int, K: int) -> int:
    return 2 * M * N * K


def _check(x, w, scale, bias, out_dtype):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.int8 or w.ndim != 2:
        raise ValueError(f"w must be int8 [N, K], got {w.dtype} "
                         f"{tuple(w.shape)}")
    N, K = w.shape
    if x.shape[-1] != K:
        raise ValueError(f"x's last dim {x.shape[-1]} != w's K {K}")
    if tuple(scale.shape) != (N,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32 [N={N}], got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"bias must be [N={N}], got {tuple(bias.shape)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"out_dtype must be x's dtype or float32, got "
                         f"{out_dtype}")
    return N, K, out_dtype


def quant_linear_reference(x, w, scale, bias=None,
                           out_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version: fp32 sums of the exact products ``x *
    q``, rounded to x's dtype, times the scale rounded to ``out_dtype``
    (in ``out_dtype``), plus the bias in ``out_dtype``."""
    N, K, out_dtype = _check(x, w, scale, bias, out_dtype)
    wt = _build.wide_dtype(x)
    y = torch.matmul(x.to(wt), w.to(wt).t()).to(x.dtype).to(out_dtype)
    y = y * scale.to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


def _split_k(M: int, N: int, K: int, device) -> tuple:
    """``(splits, depth per split)``: one split when the output tiles
    fill the card, else enough K splits for about two CTAs per SM."""
    sms = _build.sm_count(device)
    steps = math.ceil(K / BK)
    tiles = math.ceil(M / BLOCK) * math.ceil(N / BLOCK)
    want = 1 if tiles >= sms else min(steps, math.ceil(2 * sms / tiles))
    per = math.ceil(steps / want)
    return math.ceil(steps / per), per * BK


def quant_linear(x, w, scale, bias=None,
                 out_dtype: Optional[torch.dtype] = None):
    """``QuantDense``'s product (see the module docstring).  CPU tensors
    run :func:`quant_linear_reference`; CUDA tensors launch the kernel —
    building it on first use — or raise."""
    global launches, plain_calls
    N, K, out_dtype = _check(x, w, scale, bias, out_dtype)
    if not _build.on_cuda("quant_linear", x, w, scale, bias):
        plain_calls += 1
        return quant_linear_reference(x, w, scale, bias, out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    if not w.is_contiguous() or not scale.is_contiguous():
        raise ValueError("w and scale must be contiguous")
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
    splits, kper = _split_k(M, N, K, x.device)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    rc = _library().bps_quant_dot(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), M, N, K, splits, kper,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_dot kernel launch failed: cudaError {rc}")
    launches += 1
    return out.reshape(*lead, N)
