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
prefill the bf16 tensor-core rate.  Three designs, set out in the CUDA
source, and one rule among them (:func:`_design`, the C side's
``choose``, which dispatches; every call checks the launches the library
reports by design against it):

* ``swap`` — bf16 x with at most :data:`SWAP_MAX_ROWS` rows (decode):
  ``out^T = W . x^T`` on ``mma.sync``, W's int8 rows the A operand
  widened in registers, split over K by :func:`_swap_plan` and merged in
  the same launch (a ticket a channel tile, :func:`_ticket_buffer`);
* ``tma`` — bf16 x with more rows (prefill): a persistent TMA + ``wgmma``
  mainloop, W's int8 tile widened in registers as the register-sourced A
  operand, x's tile the shared-memory B operand;
* ``tile`` — the first design, a 128 x 128 ``mma.sync`` / FMA tile
  (split-K and a combine kernel, :func:`_split_k`): fp32 x and the shapes
  the other two cannot describe.

Beside the kernel:

* :func:`quant_linear_reference` — the plain PyTorch version (fp32 sums
  of the exact products, then ``QuantDense``'s rounding points);
* :func:`quantize_weight` — symmetric per-output-channel int8 of a
  ``[N, K]`` weight (``inference.quantize_params``'s rule);
* :func:`quant_linear` — the wrapper: CPU tensors take the plain version,
  CUDA tensors launch the rule's design or raise;
* :func:`quant_linear_design` — one named design at any shape it takes
  (to time the designs against each other; the model calls
  :func:`quant_linear`);
* ``launches`` (calls that launched), ``design_launches`` (kernels by
  design, from the library's count) and ``plain_calls`` counters.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from . import _build

__all__ = ["quant_linear", "quant_linear_design", "quant_linear_reference",
           "quantize_weight", "quant_flops", "build", "DESIGNS", "TILE",
           "SWAP", "TMA", "BLOCK", "BK"]

TILE, SWAP, TMA = 0, 1, 2        # the designs, as the C side numbers them
DESIGNS = ("tile", "swap", "tma")

launches = 0
plain_calls = 0
design_launches = dict.fromkeys(DESIGNS, 0)

BLOCK = 128  # tile: rows and columns of a block tile
BK = 32      # tile: depth of one K step
SWAP_MAX_ROWS = 64      # swap: the most rows of x it takes
SWAP_CHANNELS = 64      # swap: output channels of a CTA
SWAP_STEP = 128         # swap: depth of one step, and of a split's unit
SWAP_MIN_STEPS = 2      # swap: the least steps a split holds where K has them
_lib = None
_tickets: Dict[torch.device, torch.Tensor] = {}


def build():
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    return _build.build(["quant_dot"])["quant_dot"]


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("quant_dot")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bps_quant_dot.argtypes = [p] * 7 + [i] * 8 + [p, p]
        lib.bps_quant_dot.restype = i
        lib.bps_quant_dot_choose.argtypes = [i] * 4 + [p] * 3
        lib.bps_quant_dot_choose.restype = i
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


def _design(dtype: torch.dtype, M: int, N: int, K: int, x_ptr: int,
            w_ptr: int, out_ptr: int) -> int:
    """The design a call takes (the C side's ``choose``, which
    dispatches): fp32 x, K not a multiple of 16, or an x or W base not
    16-byte aligned take ``tile``; else at most :data:`SWAP_MAX_ROWS`
    rows take ``swap``; else N a multiple of 8 with a 16-byte-aligned
    output takes ``tma``; else ``tile``.  A pure function of the shapes
    and the three base addresses."""
    if (dtype != torch.bfloat16 or K % 16 or x_ptr % 16 or w_ptr % 16):
        return TILE
    if M <= SWAP_MAX_ROWS:
        return SWAP
    return TMA if N % 8 == 0 and out_ptr % 16 == 0 else TILE


def _swap_plan(M: int, N: int, K: int, sms: int) -> tuple:
    """``(splits, depth per split)`` of the swap design: about one CTA an
    SM over the ``ceil(N / 64)`` channel tiles (the nearest whole number
    of splits; a merge costs more than a second CTA an SM gains), each
    split at least :data:`SWAP_MIN_STEPS` steps of :data:`SWAP_STEP`
    deep where K has them.  A pure function of the shapes: the splits
    cover K exactly, every split but the last is the same whole number
    of steps, none is empty."""
    steps = math.ceil(K / SWAP_STEP)
    tiles = math.ceil(N / SWAP_CHANNELS)
    want = max(1, int(sms / tiles + 0.5))
    splits = min(want, max(1, steps // SWAP_MIN_STEPS))
    per = math.ceil(steps / splits)
    return math.ceil(steps / per), per * SWAP_STEP


def _ticket_buffer(device, n: int) -> torch.Tensor:
    """``n`` int32 zeros on ``device``, allocated once (grown when a call
    needs more): the swap design's merge tickets, one a channel tile,
    which each launch leaves at zero."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = _tickets[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                             device=device)
    return buf


def _kernels_for(design: int, splits: int) -> list:
    """Kernels a call of ``design`` launches, by design: the tile's
    combine kernel is a second launch where it splits K."""
    want = [0, 0, 0]
    want[design] = 2 if design == TILE and splits > 1 else 1
    return want


def _prepare(x, w, scale, bias, out_dtype):
    """Check a CUDA call; returns ``(x2 [M, K] contiguous and 16-byte
    aligned, bias in out_dtype or None, out [M, N], lead shape, out_dtype,
    M, N, K)``."""
    N, K, out_dtype = _check(x, w, scale, bias, out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    M = x2.shape[0]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError("kernel takes M, N, K below 2**31")
    if not w.is_contiguous() or not scale.is_contiguous():
        raise ValueError("w and scale must be contiguous")
    if bias is not None:
        bias = bias.to(out_dtype).contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    return x2, bias, out, lead, out_dtype, M, N, K


def _launch(x2, w, scale, bias, out, design: int, rule: bool) -> None:
    """One call of ``design`` (``rule``: the C side chooses, and must
    choose ``design``); raises unless the library launched exactly the
    kernels predicted for it."""
    M, K = x2.shape
    N = w.shape[0]
    part = tickets = None
    if design == SWAP:
        splits, kper = _swap_plan(M, N, K, _build.sm_count(x2.device))
        if splits > 1:
            tickets = _ticket_buffer(x2.device, math.ceil(N / SWAP_CHANNELS))
    elif design == TILE:
        splits, kper = _split_k(M, N, K, x2.device)
    else:
        splits, kper = 1, K
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32,
                           device=x2.device)
    counts = (ctypes.c_int * 3)()
    rc = _library().bps_quant_dot(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), M, N, K, splits,
        kper, int(x2.dtype == torch.bfloat16),
        int(out.dtype == torch.bfloat16), -1 if rule else design, counts,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_dot {DESIGNS[design]} launch failed: "
                           f"cudaError {rc}")
    took, want = list(counts), _kernels_for(design, splits)
    if took != want:
        raise RuntimeError(f"quant_dot: the library launched {took} kernels "
                           f"by design {DESIGNS}, the rule predicted {want}")
    for name, n in zip(DESIGNS, took):
        design_launches[name] += n


def quant_linear(x, w, scale, bias=None,
                 out_dtype: Optional[torch.dtype] = None):
    """``QuantDense``'s product (see the module docstring).  CPU tensors
    run :func:`quant_linear_reference`; CUDA tensors launch the design
    :func:`_design` names — building the library on first use — or
    raise."""
    global launches, plain_calls
    if not _build.on_cuda("quant_linear", x, w, scale, bias):
        plain_calls += 1
        return quant_linear_reference(x, w, scale, bias, out_dtype)
    x2, bias, out, lead, out_dtype, M, N, K = _prepare(x, w, scale, bias,
                                                       out_dtype)
    if M == 0:
        return out.reshape(*lead, N)
    design = _design(x2.dtype, M, N, K, x2.data_ptr(), w.data_ptr(),
                     out.data_ptr())
    _launch(x2, w, scale, bias, out, design, rule=True)
    launches += 1
    return out.reshape(*lead, N)


def quant_linear_design(x, w, scale, bias=None,
                        out_dtype: Optional[torch.dtype] = None, *,
                        design: int):
    """:func:`quant_linear` on CUDA tensors through the named design
    (``TILE``, ``SWAP`` or ``TMA``) whatever the rule would choose, to
    time the designs against each other at one shape; raises where the
    design does not take the shape.  Counts in ``design_launches``
    only."""
    if not _build.on_cuda("quant_linear_design", x, w, scale, bias):
        raise ValueError("quant_linear_design needs CUDA tensors")
    x2, bias, out, lead, out_dtype, M, N, K = _prepare(x, w, scale, bias,
                                                       out_dtype)
    if M:
        _launch(x2, w, scale, bias, out, design, rule=False)
    return out.reshape(*lead, N)
