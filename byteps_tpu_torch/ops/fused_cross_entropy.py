"""Fused LM-head cross-entropy — forward, dx and dW — as hand-written
Hopper kernels behind one ``torch.autograd.Function``.

Replaces the TPU kernels of ``byteps_tpu/ops/fused_cross_entropy.py``:
``_fwd_kernel`` (``:77``, its ``pallas_call`` at ``:184``), ``_dx_kernel``
(``:115``, ``:265``) and ``_dw_kernel`` (``:144``, ``:282``).  The kernels
are CUDA C++ (``byteps_tpu_torch/csrc/fused_cross_entropy.cu``), compiled
with ``nvcc`` for ``sm_90a`` at first use (``ops/_build.py``) and bound
here with ``ctypes``.

``fused_linear_cross_entropy(x [N, H], w [H, V], targets [N]) -> loss
[N]`` keeps the JAX signature and layout: the per-row softmax
cross-entropy of ``x @ w`` without the ``[N, V]`` logits, loss 0 and zero
gradient on rows whose target lies outside ``[0, V)`` (the HF ``-100``
convention).  ``block_n``/``block_v`` are the TPU's tiling hints: they
are accepted and do not change the result; the kernels take any N, H and
V (the Pallas ``fit_block`` refusal of, e.g., V = 50257 is a TPU limit).
``w`` is typically ``table.t()``, a ``[H, V]`` view of a ``[V, H]``
embedding or ``nn.Linear`` weight: the kernels read that table's rows
where they lie (no copy); only a ``w`` laid out ``[H, V]`` itself is
transposed into a copy.  x and w must share a dtype on the card (float32
or bfloat16); targets are int32 or int64.

In bf16 every kernel (forward, dlogits, dx and dW) comes in two designs,
chosen by the C side on a stated rule on the operands: where TMA can
describe them (16-byte-aligned bases, H and the row strides multiples of
8; dW holds to the table's stride too, so a backward chunk runs one
design throughout), a persistent kernel on TMA loads and ``wgmma``
tensor-core products; elsewhere (e.g. H = 36, or a table of row stride
H + 1) the first design's ``mma.sync`` kernels.  fp32 always takes
scalar FMA (tensor cores would mean TF32).  :func:`_tma_ok` states the
same rule (the forward sizes its splits by it); the library counts the
TMA kernels it launches, and every call checks that count against the
rule's prediction, so the two cannot part silently.

The backward walks the vocabulary in chunks of :data:`VOCAB_CHUNK`
columns, in order: the dlogits kernel writes ``(softmax - onehot) * dl``
of the chunk, rounded to the operand dtype, into one ``[N, chunk]``
scratch; the dx kernel adds ``dlogits @ W_c`` into an fp32 ``[N, H]``
accumulator (the last chunk writes dx in x's dtype); the dW kernel writes
the chunk's rows of dW, complete, from an fp32 sum over all N rows (see
the source note for why the TPU's accumulators do not fit a Hopper
block).  dW comes back as the ``[H, V]`` transpose view of a ``[V, H]``
tensor, the layout of the table it flows back to.

Beside the kernels:

* the plain versions :func:`fce_forward_reference`,
  :func:`fce_backward_dx_reference` and :func:`fce_backward_dw_reference`
  — chunked over V (no ``[N, V]`` buffer at full size), with the TPU
  kernels' rounding points: products of input-dtype values summed in
  fp32, dlogits rounded to w's dtype before the dx product and to x's
  before the dW product;
* :class:`FusedLinearCrossEntropy` — forward saves ``(x, w, targets,
  lse)``; backward masks the loss cotangent to the valid rows and runs
  the backward kernels.  CPU tensors take the plain versions; CUDA
  tensors launch the kernels or raise — no fallback;
* launch counters ``fwd_launches`` (one a forward call), ``dx_launches``
  (one a vocabulary chunk: the dlogits and dx kernels), ``dw_launches``
  (one a chunk), and ``plain_calls`` for CPU dispatches;
  ``tma_launches`` counts the TMA kernels the library reports launching
  (one a bf16 forward, one dlogits, one dx and one dW a chunk where they
  took that design).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = ["fused_linear_cross_entropy", "FusedLinearCrossEntropy",
           "fce_forward_reference", "fce_backward_dx_reference",
           "fce_backward_dw_reference", "fce_forward", "fce_backward",
           "fce_flops", "vocab_chunks", "VOCAB_CHUNK", "build"]

fwd_launches = 0
dx_launches = 0
dw_launches = 0
plain_calls = 0
tma_launches = 0

VOCAB_CHUNK = 8192     # vocabulary columns of one backward chunk
_FWD_BLOCKS = 4 * 132  # forward blocks to aim for: ~4 per H100 SM
_ROWS = 128            # rows (and vocabulary columns) of a kernel tile
_TMA_COLS = 256        # vocabulary columns of a TMA kernel's tile (TN)
_lib = None


def build():
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    return _build.build(["fused_cross_entropy"])["fused_cross_entropy"]


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("fused_cross_entropy")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bps_fce_fwd.argtypes = [p, p, p, i, p, p, p, i, i, i, ll, i, i, p]
        lib.bps_fce_dlogits.argtypes = [p, p, p, i, p, p, p, i, i, i, i, i,
                                        ll, ll, i, p]
        lib.bps_fce_dx.argtypes = [p, p, p, p, i, i, i, ll, ll, i, i, i, p]
        lib.bps_fce_dw.argtypes = [p, p, p, i, i, i, ll, ll, i, p]
        for fn in (lib.bps_fce_fwd, lib.bps_fce_dlogits, lib.bps_fce_dx,
                   lib.bps_fce_dw):
            fn.restype = i
        lib.bps_fce_tma_launches.argtypes = []
        lib.bps_fce_tma_launches.restype = ll
        _lib = lib
    return _lib


def vocab_chunks(V: int) -> int:
    """Backward chunks (dx and dW launches) for a vocabulary of V."""
    return -(-V // _chunk(V))


def fce_flops(N: int, H: int, V: int) -> dict:
    """FLOPs of each kernel: the forward's logits (2·NVH), dlogits + the dx
    product (4·NVH), the dW product (2·NVH)."""
    n = 2 * N * V * H
    return {"fwd": n, "dx": 2 * n, "dw": n}


# ------------------------------------------------------------- checks


def _check(x, w, targets):
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"want x [N, H] and w [H, V], got {tuple(x.shape)} "
                         f"/ {tuple(w.shape)}")
    N, H = x.shape
    if tuple(targets.shape) != (N,):
        raise ValueError(f"targets must be [N]={N}, got "
                         f"{tuple(targets.shape)}")
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise ValueError(f"targets must be integers, got {targets.dtype}")
    return N, H, w.shape[1]


def _chunk(V: int) -> int:
    # a multiple of 8, so the scratch's bf16 rows stay 16-byte aligned
    return min(VOCAB_CHUNK, -(-V // 8) * 8)


def _kernel_args(x, w, targets):
    """Check what the kernels take; return contiguous x, W as ``[V, H]``
    rows with their row stride, the targets and whether they are int64."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype:
        raise ValueError(f"w dtype {w.dtype} != x dtype {x.dtype}")
    if max(x.shape[0], w.shape[1]) >= 2 ** 31 or w.shape[0] >= 2 ** 31:
        raise ValueError("kernel takes N, H, V below 2**31")
    rows = w.t()                 # the [V, H] table a tied head is a view of
    if rows.stride(1) != 1:      # w laid out [H, V] itself
        rows = rows.contiguous()
    t = targets if targets.dtype in (torch.int32, torch.int64) \
        else targets.long()
    return (x.contiguous(), rows, rows.stride(0), t.contiguous(),
            int(t.dtype == torch.int64))


def _tma_ok(H: int, ldw: int, ldd: int, *operands) -> bool:
    """Whether a kernel on TMA and ``wgmma`` takes these operands (the C
    side's ``tma_ok``, which dispatches): every operand bf16 with a
    16-byte-aligned base; H and the row strides of W (``ldw``) and the
    dlogits scratch (``ldd``) multiples of 8 elements (16 bytes)."""
    return (H % 8 == 0 and ldw % 8 == 0 and ldd % 8 == 0
            and all(a.dtype == torch.bfloat16 and a.data_ptr() % 16 == 0
                    for a in operands))


def _count_tma(lib, before: int, want: int, what: str) -> None:
    """Add the TMA kernels the library launched since it read ``before``
    to ``tma_launches``; they must be the ``want`` that :func:`_tma_ok`
    predicted."""
    global tma_launches
    took = lib.bps_fce_tma_launches() - before
    if took != want:
        raise RuntimeError(f"fused cross-entropy {what}: the library "
                           f"launched {took} TMA kernels, the path rule "
                           f"predicted {want}")
    tma_launches += took


def _fwd_splits(N: int, V: int, tma: bool, sms: int) -> int:
    """Vocabulary splits of the forward.  The TMA kernel is persistent
    (one CTA an SM over (row tile, split) units): the smallest number of
    splits that makes the units a whole number of waves, at most one a
    vocabulary tile.  The first design aims at ~4 blocks an SM."""
    row_blocks = -(-N // _ROWS)
    if tma:
        return max(1, min(-(-V // _TMA_COLS),
                          sms // math.gcd(row_blocks, sms)))
    return max(1, min(-(-V // _ROWS), -(-_FWD_BLOCKS // row_blocks)))


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused cross-entropy {what} kernel launch "
                           f"failed: cudaError {rc}")


# ------------------------------------------------------ plain versions


def _dlogits(xf, wc, t, c0, lse, dl):
    """``(exp(x wc - lse) - onehot) * dl`` of columns ``[c0, c0 + c)``."""
    p = torch.exp(xf @ wc - lse[:, None])
    cols = torch.arange(c0, c0 + wc.shape[1], device=xf.device)
    return (p - (t[:, None] == cols[None]).to(p.dtype)) * dl[:, None]


def fce_forward_reference(x, w, targets, chunk: int = VOCAB_CHUNK):
    """Plain version of the forward kernel: ``(lse [N], target logit
    [N])`` in fp32 (fp64 for fp64 inputs), walking V in chunks."""
    N, H, V = _check(x, w, targets)
    wt = _build.wide_dtype(x, w)
    xf, t = x.to(wt), targets.long()
    parts, tl = [], torch.zeros(N, dtype=wt, device=x.device)
    for c0 in range(0, V, chunk):
        logits = xf @ w[:, c0:c0 + chunk].to(wt)
        c = logits.shape[1]
        parts.append(torch.logsumexp(logits, dim=1))
        picked = logits.gather(1, (t - c0).clamp(0, c - 1)[:, None])[:, 0]
        tl = tl + torch.where((t >= c0) & (t < c0 + c), picked, 0.0)
    return torch.logsumexp(torch.stack(parts), dim=0), tl


def fce_backward_dx_reference(x, w, targets, lse, dl,
                              chunk: int = VOCAB_CHUNK):
    """Plain version of the dlogits + dx kernels: ``dx = sum_c
    dlogits_c(->w.dtype) @ W_c^T`` in fp32, cast to x's dtype.  ``dl`` is
    the per-row loss cotangent, already zero on ignored rows."""
    N, H, V = _check(x, w, targets)
    wt = _build.wide_dtype(x, w)
    xf, t = x.to(wt), targets.long()
    lse, dl = lse.to(wt), dl.to(wt)
    dx = torch.zeros((N, H), dtype=wt, device=x.device)
    for c0 in range(0, V, chunk):
        wc = w[:, c0:c0 + chunk].to(wt)
        d = _dlogits(xf, wc, t, c0, lse, dl).to(w.dtype).to(wt)
        dx += d @ wc.t()
    return dx.to(x.dtype)


def fce_backward_dw_reference(x, w, targets, lse, dl,
                              chunk: int = VOCAB_CHUNK):
    """Plain version of the dW kernel (with its dlogits): ``dW[:, c] =
    x^T @ dlogits_c(->x.dtype)`` in fp32, ``[H, V]`` in w's dtype."""
    N, H, V = _check(x, w, targets)
    wt = _build.wide_dtype(x, w)
    xf, t = x.to(wt), targets.long()
    lse, dl = lse.to(wt), dl.to(wt)
    dw = torch.empty((H, V), dtype=w.dtype, device=w.device)
    for c0 in range(0, V, chunk):
        wc = w[:, c0:c0 + chunk].to(wt)
        d = _dlogits(xf, wc, t, c0, lse, dl).to(x.dtype).to(wt)
        dw[:, c0:c0 + chunk] = (xf.t() @ d).to(w.dtype)
    return dw


# ------------------------------------------------------- dispatchers


def fce_forward(x, w, targets):
    """``(lse, target logit)``, ``[N]`` fp32 each: the forward kernel on
    CUDA tensors, the plain version on CPU tensors."""
    global fwd_launches, plain_calls
    N, H, V = _check(x, w, targets)
    if not _build.on_cuda("fused cross-entropy", x, w, targets):
        plain_calls += 1
        return fce_forward_reference(x, w, targets)
    x, rows, ldw, t, t64 = _kernel_args(x, w, targets)
    tma = _tma_ok(H, ldw, 8, x, rows)
    splits = _fwd_splits(N, V, tma, _build.sm_count(x.device))
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((3, splits, N), **f32)
    lse, tl = torch.empty(N, **f32), torch.empty(N, **f32)
    lib = _library()
    before = lib.bps_fce_tma_launches()
    rc = lib.bps_fce_fwd(
        x.data_ptr(), rows.data_ptr(), t.data_ptr(), t64, part.data_ptr(),
        lse.data_ptr(), tl.data_ptr(), N, H, V, ldw, splits,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "forward")
    fwd_launches += 1
    _count_tma(lib, before, int(tma), "forward")
    return lse, tl


def fce_backward(x, w, targets, lse, dl, need_dx: bool = True,
                 need_dw: bool = True):
    """``(dx [N, H] | None, dW [H, V] | None)`` from the saved lse and the
    per-row cotangent ``dl`` (zero on ignored rows): the backward kernels
    on CUDA tensors, the plain versions on CPU tensors."""
    global dx_launches, dw_launches, plain_calls
    N, H, V = _check(x, w, targets)
    if not _build.on_cuda("fused cross-entropy", x, w, targets, lse, dl):
        plain_calls += 1
        return ((fce_backward_dx_reference(x, w, targets, lse, dl)
                 if need_dx else None),
                (fce_backward_dw_reference(x, w, targets, lse, dl)
                 if need_dw else None))
    x, rows, ldw, t, t64 = _kernel_args(x, w, targets)
    lse, dl = lse.float().contiguous(), dl.float().contiguous()
    lib, elt = _library(), x.element_size()
    dt = int(x.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    vc = _chunk(V)
    d = torch.empty((N, vc), dtype=x.dtype, device=x.device)  # dlogits
    dx = acc = dw = None
    if need_dx:
        dx = torch.empty_like(x)
        # the fp32 sum across chunks: dx itself in fp32; none with one chunk
        acc = dx if x.dtype == torch.float32 else (
            torch.empty((N, H), dtype=torch.float32, device=x.device)
            if V > vc else None)
    if need_dw:
        dw = torch.empty((V, H), dtype=x.dtype, device=x.device)
    # TMA kernels a chunk launches: dlogits reads x, W and d, dx d and W,
    # dW d and x and writes dW's rows (held to W's stride too)
    tma = (int(_tma_ok(H, ldw, vc, x, rows, d))
           + int(need_dx and _tma_ok(H, ldw, vc, d, rows))
           + int(need_dw and _tma_ok(H, ldw, vc, d, x, dw)))
    for c0 in range(0, V, vc):
        vw = min(vc, V - c0)
        wc = rows.data_ptr() + c0 * ldw * elt
        before = lib.bps_fce_tma_launches()
        _raise_on(lib.bps_fce_dlogits(
            x.data_ptr(), wc, t.data_ptr(), t64, lse.data_ptr(),
            dl.data_ptr(), d.data_ptr(), N, H, vw, c0, V, ldw, vc, dt,
            stream), "dlogits")
        if need_dx:
            _raise_on(lib.bps_fce_dx(
                d.data_ptr(), wc, None if acc is None else acc.data_ptr(),
                dx.data_ptr(), N, H, vw, vc, ldw, int(c0 == 0),
                int(c0 + vw == V), dt, stream), "dx")
            dx_launches += 1
        if need_dw:
            _raise_on(lib.bps_fce_dw(
                d.data_ptr(), x.data_ptr(), dw.data_ptr() + c0 * H * elt, N,
                H, vw, vc, ldw, dt, stream), "dW")
            dw_launches += 1
        _count_tma(lib, before, tma, "backward chunk")
    return dx, (None if dw is None else dw.t())


# ------------------------------------------------------ autograd


class FusedLinearCrossEntropy(torch.autograd.Function):
    """Per-row loss ``[N]`` with the fused backward.  CPU tensors run the
    plain versions, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, x, w, targets):
        lse, tl = fce_forward(x, w, targets)
        valid = (targets >= 0) & (targets < w.shape[1])
        ctx.save_for_backward(x, w, targets, lse)
        ctx.set_materialize_grads(False)
        return torch.where(valid, lse - tl, 0.0)

    @staticmethod
    def backward(ctx, dloss):
        if dloss is None:
            return None, None, None
        x, w, targets, lse = ctx.saved_tensors
        # ignored rows get a zero cotangent, so no gradient flows from them
        valid = (targets >= 0) & (targets < w.shape[1])
        dl = dloss.to(lse.dtype) * valid
        dx, dw = fce_backward(x, w, targets, lse, dl, ctx.needs_input_grad[0],
                              ctx.needs_input_grad[1])
        return dx, dw, None


def fused_linear_cross_entropy(x, w, targets,
                               block_n: Optional[int] = None,
                               block_v: Optional[int] = None):
    """Per-row softmax cross-entropy of ``x @ w`` against integer
    ``targets`` without the ``[N, V]`` logits: ``x [N, H]``, ``w [H, V]``,
    ``targets [N]`` -> ``loss [N]`` fp32 (see the module docstring).
    ``block_n``/``block_v`` are accepted for the JAX signature and do not
    change the result."""
    for b in (block_n, block_v):
        if b is not None and int(b) < 1:
            raise ValueError(f"block sizes must be positive, got {b}")
    return FusedLinearCrossEntropy.apply(x, w, targets)
