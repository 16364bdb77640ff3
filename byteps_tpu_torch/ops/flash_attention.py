"""Flash attention — forward, dq and dk/dv — as hand-written Hopper
kernels behind one ``torch.autograd.Function``.

Replaces the TPU kernels of ``byteps_tpu/ops/flash_attention.py``:
``_fwd_kernel`` (``:116``, its ``pallas_call`` at ``:288``),
``_bwd_dq_kernel`` (``:374``, ``:625``) and ``_bwd_dkv_kernel`` (``:444``,
``:661``).  The kernels are CUDA C++ (``byteps_tpu_torch/csrc/
flash_attention.cu``), compiled with ``nvcc`` for ``sm_90a`` at first
use (``ops/_build.py``) and bound here with ``ctypes``.

Layout as in the JAX package: q ``[B, T, H, D]``, k/v ``[B, T, KV, D]``
with ``H % KV == 0`` (GQA/MQA: query head ``h`` reads KV head
``h // (H/KV)``).  Options: ``causal``, a sliding ``window`` (requires
causal), ``segment_ids [B, T]`` (packed documents / HF padding: a query
sees only keys of its own segment), ``alibi_slopes [H]`` (bias
``slope_h * (col - row)``, requires causal; a constant, its gradient is
zero).  Head dims 16, 32, 64 and 128, float32 or bfloat16, any T — the
Pallas ``fit_block`` divisibility refusal is a TPU limit the kernels do
not copy.  ``block_q``/``block_k``/``interpret`` are Pallas switches and
are not ported.

Beside the kernels:

* the plain versions :func:`flash_forward_reference`,
  :func:`flash_backward_dq_reference` and
  :func:`flash_backward_dkv_reference` — dense masked softmax over the
  whole ``[T, T]`` score matrix with each TPU kernel's rounding points
  (dots of input-dtype values summed in fp32, fp32 softmax, ``p`` and
  ``ds`` rounded to the operand dtype before their dots).  dk/dv sum
  the head group in fp32 and round once (the TPU wrapper rounds each
  head, then sums — the same in fp32);
* :class:`FlashAttention` — forward saves ``(q, k, v, o, lse,
  segment_ids, alibi_slopes)``; backward computes ``delta =
  rowsum(dO * o)`` (minus the lse cotangent) and calls dq and dk/dv.
  CPU tensors take the plain versions; CUDA tensors launch the kernels
  or raise — no fallback;
* launch counters ``fwd_launches``, ``dq_launches``, ``dkv_launches``
  (plain integers), and ``plain_calls`` for CPU dispatches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_with_lse", "FlashAttention",
           "flash_forward_reference", "flash_backward_dq_reference",
           "flash_backward_dkv_reference", "flash_forward",
           "flash_backward_dq", "flash_backward_dkv", "attention_flops",
           "HEAD_DIMS", "build"]

fwd_launches = 0
dq_launches = 0
dkv_launches = 0
plain_calls = 0

HEAD_DIMS = (16, 32, 64, 128)
_MASKED = -1e30
_lib = None


def build():
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    return _build.build(["flash_attention"])["flash_attention"]


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i, i, i, i, i, i, i, i, f, p]  # B T H KV D causal window
        lib.bps_flash_fwd.argtypes = [p] * 7 + tail    # dtype scale stream
        lib.bps_flash_bwd_dq.argtypes = [p] * 9 + tail
        lib.bps_flash_bwd_dkv.argtypes = [p] * 10 + tail
        for fn in (lib.bps_flash_fwd, lib.bps_flash_bwd_dq,
                   lib.bps_flash_bwd_dkv):
            fn.restype = i
        _lib = lib
    return _lib


# ------------------------------------------------------------- checks


def _check(q, k, v, causal, window, segment_ids, alibi_slopes):
    """Validate shapes and options (the JAX ``_gqa_group`` and
    ``_check_band_args``); returns ``(B, T, H, KV, D)``."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B, T, H, D] and k/v [B, T, KV, D], got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    B, T, H, D = q.shape
    KV = k.shape[2]
    if k.shape[:2] != (B, T) or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"q heads {H} not a multiple of kv heads {KV}")
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if alibi_slopes is not None:
        if not causal:
            raise ValueError("alibi_slopes requires causal=True")
        if tuple(alibi_slopes.shape) != (H,):
            raise ValueError(f"alibi_slopes must be [H]={H}, got "
                             f"{tuple(alibi_slopes.shape)}")
    if segment_ids is not None and tuple(segment_ids.shape) != (B, T):
        raise ValueError(f"segment_ids must be [B, T]={(B, T)}, got "
                         f"{tuple(segment_ids.shape)}")
    return B, T, H, KV, D


def _kernel_args(q, k, v, *more, segment_ids=None, alibi_slopes=None):
    """Check what the kernels take and return contiguous, 16-byte
    aligned operands plus int32 segment ids and fp32 slopes."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")

    def prep(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    ops = [prep(t) for t in (q, k, v, *more)]
    seg = (None if segment_ids is None
           else segment_ids.to(torch.int32).contiguous())
    slopes = (None if alibi_slopes is None
              else alibi_slopes.detach().to(torch.float32).contiguous())
    return ops, seg, slopes


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"cudaError {rc}")


# ------------------------------------------------------ plain versions


def _grouped(x, KV):
    """``[B, T, H, D] -> [B, KV, G, T, D]`` (head ``h = kv * G + g``)."""
    B, T, H, D = x.shape
    return x.reshape(B, T, KV, H // KV, D).permute(0, 2, 3, 1, 4)


def _ungrouped(x):
    """Inverse of :func:`_grouped`."""
    B, KV, G, T, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, T, KV * G, D)


def _scores(q, k, causal, scale, segment_ids, window, alibi_slopes):
    """fp32 scores ``[B, KV, G, T, T]`` with masked entries at -1e30, and
    the keep-mask (broadcastable to them)."""
    B, T, H, D = q.shape
    KV = k.shape[2]
    wt = _build.wide_dtype(q, k)
    qg = _grouped(q.to(wt), KV)
    kg = k.to(wt).permute(0, 2, 1, 3)[:, :, None]       # [B, KV, 1, T, D]
    s = torch.matmul(qg, kg.transpose(-1, -2)) * scale
    r = torch.arange(T, device=q.device)[:, None]
    c = torch.arange(T, device=q.device)[None, :]
    if alibi_slopes is not None:
        sl = alibi_slopes.detach().to(wt).view(KV, H // KV)
        s = s + sl[None, :, :, None, None] * (c - r).to(wt)
    valid = torch.ones((T, T), dtype=torch.bool, device=q.device)
    if causal:
        valid = r >= c
        if window is not None:
            valid = valid & (r - c < window)
    valid = valid[None, None, None]
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        valid = valid & same[:, None, None]
    return s.masked_fill(~valid, _MASKED), valid


def _probs(s, valid, lse, KV):
    """``p = exp(s - lse)`` on attended entries, 0 elsewhere."""
    B, H, T = lse.shape
    p = torch.exp(s - lse.view(B, KV, H // KV, T, 1))
    return p.masked_fill(~valid, 0.0)


def flash_forward_reference(q, k, v, causal: bool = False,
                            scale: Optional[float] = None, segment_ids=None,
                            window: Optional[int] = None, alibi_slopes=None):
    """Plain version of the forward kernel: returns ``(o [B, T, H, D]``
    in q's dtype, ``lse [B, H, T]`` fp32)."""
    B, T, H, KV, D = _check(q, k, v, causal, window, segment_ids,
                            alibi_slopes)
    scale = D ** -0.5 if scale is None else scale
    wt = _build.wide_dtype(q, k, v)
    s, valid = _scores(q, k, causal, scale, segment_ids, window,
                       alibi_slopes)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    vg = v.permute(0, 2, 1, 3)[:, :, None]               # [B, KV, 1, T, D]
    o = torch.matmul(p.to(v.dtype).to(wt), vg.to(wt)) / den
    o = _ungrouped(o).to(q.dtype)
    lse = (m + torch.log(den)).reshape(B, H, T)
    return o, lse


def flash_backward_dq_reference(q, k, v, do, lse, delta, causal: bool = False,
                                scale: Optional[float] = None,
                                segment_ids=None,
                                window: Optional[int] = None,
                                alibi_slopes=None):
    """Plain version of the dq kernel: ``p = exp(s - lse)``, ``ds = p (dO
    v^T - delta)`` rounded to k's dtype, ``dq = scale ds k`` in q's
    dtype.  ``lse`` and ``delta`` are ``[B, H, T]`` fp32."""
    B, T, H, KV, D = _check(q, k, v, causal, window, segment_ids,
                            alibi_slopes)
    scale = D ** -0.5 if scale is None else scale
    wt = _build.wide_dtype(q, k, v)
    s, valid = _scores(q, k, causal, scale, segment_ids, window,
                       alibi_slopes)
    p = _probs(s, valid, lse, KV)
    vg = v.to(wt).permute(0, 2, 1, 3)[:, :, None]
    dp = torch.matmul(_grouped(do.to(wt), KV), vg.transpose(-1, -2))
    ds = p * (dp - delta.view(B, KV, H // KV, T, 1))
    kg = k.to(wt).permute(0, 2, 1, 3)[:, :, None]
    dq = torch.matmul(ds.to(k.dtype).to(wt), kg) * scale
    return _ungrouped(dq).to(q.dtype)


def flash_backward_dkv_reference(q, k, v, do, lse, delta,
                                 causal: bool = False,
                                 scale: Optional[float] = None,
                                 segment_ids=None,
                                 window: Optional[int] = None,
                                 alibi_slopes=None):
    """Plain version of the dk/dv kernel: ``dv = p^T dO`` (p rounded to
    dO's dtype) and ``dk = scale ds^T q`` (ds rounded to q's dtype),
    summed over each KV head's query-head group in fp32 and rounded once
    to k's dtype.  Returns ``(dk, dv)`` as ``[B, T, KV, D]``."""
    B, T, H, KV, D = _check(q, k, v, causal, window, segment_ids,
                            alibi_slopes)
    scale = D ** -0.5 if scale is None else scale
    wt = _build.wide_dtype(q, k, v)
    s, valid = _scores(q, k, causal, scale, segment_ids, window,
                       alibi_slopes)
    p = _probs(s, valid, lse, KV)
    dog = _grouped(do.to(wt), KV)
    dv = torch.matmul(p.to(do.dtype).to(wt).transpose(-1, -2), dog).sum(2)
    vg = v.to(wt).permute(0, 2, 1, 3)[:, :, None]
    dp = torch.matmul(dog, vg.transpose(-1, -2))
    ds = p * (dp - delta.view(B, KV, H // KV, T, 1))
    dk = torch.matmul(ds.to(q.dtype).to(wt).transpose(-1, -2),
                      _grouped(q.to(wt), KV)).sum(2) * scale
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


# ------------------------------------------------------- dispatchers


def flash_forward(q, k, v, causal: bool = False,
                  scale: Optional[float] = None, segment_ids=None,
                  window: Optional[int] = None, alibi_slopes=None):
    """``(o, lse [B, H, T])``: the forward kernel on CUDA tensors, the
    plain version on CPU tensors."""
    global fwd_launches, plain_calls
    B, T, H, KV, D = _check(q, k, v, causal, window, segment_ids,
                            alibi_slopes)
    scale = D ** -0.5 if scale is None else scale
    if not _build.on_cuda("flash attention", q, k, v, segment_ids,
                          alibi_slopes):
        plain_calls += 1
        return flash_forward_reference(q, k, v, causal, scale, segment_ids,
                                       window, alibi_slopes)
    (q, k, v), seg, slopes = _kernel_args(
        q, k, v, segment_ids=segment_ids, alibi_slopes=alibi_slopes)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    rc = _library().bps_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg), _ptr(slopes),
        o.data_ptr(), lse.data_ptr(), B, T, H, KV, D, int(causal),
        window or 0, int(q.dtype == torch.bfloat16), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "forward")
    fwd_launches += 1
    return o, lse


def flash_backward_dq(q, k, v, do, lse, delta, causal: bool = False,
                      scale: Optional[float] = None, segment_ids=None,
                      window: Optional[int] = None, alibi_slopes=None):
    """dq: the dq kernel on CUDA tensors, the plain version on CPU."""
    global dq_launches, plain_calls
    B, T, H, KV, D = _check(q, k, v, causal, window, segment_ids,
                            alibi_slopes)
    scale = D ** -0.5 if scale is None else scale
    if not _build.on_cuda("flash attention", q, k, v, do, lse, delta,
                          segment_ids, alibi_slopes):
        plain_calls += 1
        return flash_backward_dq_reference(q, k, v, do, lse, delta, causal,
                                           scale, segment_ids, window,
                                           alibi_slopes)
    (q, k, v, do, lse, delta), seg, slopes = _kernel_args(
        q, k, v, do, lse.float(), delta.float(), segment_ids=segment_ids,
        alibi_slopes=alibi_slopes)
    if do.dtype != q.dtype:
        raise ValueError(f"dO dtype {do.dtype} != q dtype {q.dtype}")
    dq = torch.empty_like(q)
    rc = _library().bps_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(seg), _ptr(slopes),
        dq.data_ptr(), B, T, H, KV, D, int(causal), window or 0,
        int(q.dtype == torch.bfloat16), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "dq")
    dq_launches += 1
    return dq


def flash_backward_dkv(q, k, v, do, lse, delta, causal: bool = False,
                       scale: Optional[float] = None, segment_ids=None,
                       window: Optional[int] = None, alibi_slopes=None):
    """``(dk, dv)``: the dk/dv kernel on CUDA tensors, the plain version
    on CPU."""
    global dkv_launches, plain_calls
    B, T, H, KV, D = _check(q, k, v, causal, window, segment_ids,
                            alibi_slopes)
    scale = D ** -0.5 if scale is None else scale
    if not _build.on_cuda("flash attention", q, k, v, do, lse, delta,
                          segment_ids, alibi_slopes):
        plain_calls += 1
        return flash_backward_dkv_reference(q, k, v, do, lse, delta, causal,
                                            scale, segment_ids, window,
                                            alibi_slopes)
    (q, k, v, do, lse, delta), seg, slopes = _kernel_args(
        q, k, v, do, lse.float(), delta.float(), segment_ids=segment_ids,
        alibi_slopes=alibi_slopes)
    if do.dtype != q.dtype:
        raise ValueError(f"dO dtype {do.dtype} != q dtype {q.dtype}")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _library().bps_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(seg), _ptr(slopes),
        dk.data_ptr(), dv.data_ptr(), B, T, H, KV, D, int(causal),
        window or 0, int(q.dtype == torch.bfloat16), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "dk/dv")
    dkv_launches += 1
    return dk, dv


def attention_flops(B: int, T: int, H: int, D: int, causal: bool,
                    window: Optional[int] = None) -> dict:
    """FLOPs each kernel must do for these shapes, counting only the
    attended (row, col) pairs: 4·D per pair forward (QK and PV), 6·D for
    dq (QK, dO·V, dS·K) and 8·D for dk/dv (QK, dO·V, PᵀdO, dSᵀQ)."""
    if not causal:
        pairs = T * T
    elif window is None:
        pairs = T * (T + 1) // 2
    else:
        w = min(window, T)
        pairs = T * w - w * (w - 1) // 2
    n = B * H * pairs * D
    return {"fwd": 4 * n, "dq": 6 * n, "dkv": 8 * n}


# ------------------------------------------------------ autograd


class FlashAttention(torch.autograd.Function):
    """``(o, lse [B, H, T])`` with the flash backward.  CPU tensors run the
    plain versions, CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, segment_ids, window,
                alibi_slopes):
        o, lse = flash_forward(q, k, v, causal, scale, segment_ids, window,
                               alibi_slopes)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids, alibi_slopes)
        ctx.opts = (causal, scale, window)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, segment_ids, alibi_slopes = ctx.saved_tensors
        causal, scale, window = ctx.opts
        if do is None:
            do = torch.zeros_like(o)
        B, T, H, _ = o.shape
        # delta = rowsum(dO * o) [B, H, T], the softmax-jacobian term; the
        # lse cotangent folds in as delta - dlse (d lse / d s = p)
        wt = _build.wide_dtype(o, do)
        delta = (do.to(wt) * o.to(wt)).sum(-1).permute(0, 2, 1)
        if dlse is not None:
            delta = delta - dlse.to(wt)
        delta = delta.contiguous()
        args = (causal, scale, segment_ids, window, alibi_slopes)
        dq = flash_backward_dq(q, k, v, do.to(q.dtype), lse, delta, *args)
        dk, dv = flash_backward_dkv(q, k, v, do.to(q.dtype), lse, delta,
                                    *args)
        dslopes = (torch.zeros_like(alibi_slopes)
                   if ctx.needs_input_grad[7] else None)
        return dq, dk, dv, None, None, None, None, dslopes


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, segment_ids=None,
                    window: Optional[int] = None, alibi_slopes=None):
    """Exact attention with the flash kernels: q ``[B, T, H, D]``, k/v
    ``[B, T, KV, D]`` -> ``[B, T, H, D]`` (see the module docstring)."""
    o, _ = FlashAttention.apply(q, k, v, causal, scale, segment_ids, window,
                                alibi_slopes)
    return o


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None):
    """``(o, lse)`` with ``lse [B, T, H]`` fp32, differentiable in both
    (the combinable form ring attention folds per block; the lse
    cotangent rides the same backward kernels)."""
    o, lse = FlashAttention.apply(q, k, v, causal, scale, None, None, None)
    return o, lse.permute(0, 2, 1)
