"""Paged-attention decode: block-table-indexed KV reads on Hopper.

Replaces the TPU kernel ``byteps_tpu/ops/paged_attention.py:76``
``_paged_kernel`` (its ``pallas_call`` at ``:286``, wrapper
``paged_decode_attention`` at ``:165``) in its fp and int8 modes, and the
tensor-parallel wrapper ``paged_decode_attention_sharded`` (``:306``).
The kernel is hand-written CUDA C++
(``byteps_tpu_torch/csrc/paged_attention.cu``), compiled with ``nvcc``
for ``sm_90a`` at first use into ``build/byteps_tpu_torch/`` as a shared
library with a plain C interface (``ops/_build.py``), and bound here
with ``ctypes``.

What it computes (the counterpart of ``paged_decode_attention``):
``q [B, tq, H, D]`` against flat pools ``ck/cv [n_blocks, block, KV*D]``
through ``table [B, max_blocks]`` (int32, unallocated entries = the null
block) at per-slot cursors ``pos [B]`` (int32), with an optional causal
``window``.  Query row ``(i, h)`` attends key ``c`` iff ``c <= pos + i``
(and ``c > pos + i - window``); head ``h`` reads KV head ``h // (H/KV)``.
Only the blocks that hold a readable key are read, so the null block's
padding never is.  Output ``[B, tq, H, D]`` in q's dtype.  ``tq`` is 1
for a decode step and ``k + 1`` for a speculative verify.  Int8 pools
(``kv_dtype="int8"``) hold s8 values with fp32 per-(position, KV head)
scale pools ``k_scale/v_scale [n_blocks, block, KV]``; q stays fp32 or
bf16.

What bounds it: HBM bytes — :func:`kv_bytes_read`, each slot's covered
blocks of K and V (and their scales) — at about 2 FLOPs per byte.  The
design (one CTA per (KV head, slot), one warp per query row, each KV
block staged once in shared memory for the whole GQA group, s8 widened
as it is staged) is set out in the CUDA source, with what it leaves for
later (split-K, TMA, wgmma).

Beside the kernel:

* :func:`paged_attention_reference` — the plain PyTorch version: gather
  each slot's blocks into a dense row, masked softmax, with the kernel's
  rounding points.  The CPU tests use it; ``chip_smoke.py`` holds the
  kernel against it on the card.
* :func:`paged_attention` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise.  There is no
  fallback from a failed build or launch.
* :func:`paged_attention_sharded` — per-shard pools ``[tp, n_blocks,
  block, (KV/tp)*D]`` (and scale pools ``[tp, n_blocks, block, KV/tp]``):
  one :func:`paged_attention` per shard on its query-head slice, the
  outputs concatenated on the head axis.
* ``launches`` — kernel launches made by the wrapper (a plain integer);
  ``plain_calls`` — dispatches to the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_sharded",
           "paged_attention_reference", "build", "check_kernel_config",
           "kv_bytes_read", "launches", "plain_calls", "HEAD_DIMS",
           "KV_DTYPES"]

launches = 0
plain_calls = 0

MAX_BLOCK = 64
HEAD_DIMS = (16, 32, 64, 128)
KV_DTYPES = ("", "int8")  # the pool's: q's dtype, or s8 with fp32 scales
_lib = None


def build():
    """Compile the kernel library if this source has not been built yet
    (``ops/_build.py``); returns its path."""
    return _build.build(["paged_attention"])["paged_attention"]


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        fn = lib.bps_paged_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 10 + [ctypes.c_float, p]
        fn.restype = i
        _lib = lib
    return _lib


def _check_shapes(q, ck, cv, table, pos, k_scale=None, v_scale=None):
    """Shapes of the call; also the scale rules of the JAX wrapper
    (``paged_attention.py:196-224``): both scales or neither, an int8
    pool needs them, and they are ``[n_blocks, block, KV]``."""
    if q.ndim != 4 or ck.ndim != 3:
        raise ValueError(f"want q [B, tq, H, D] and pools [n_blocks, "
                         f"block, KV*D], got {tuple(q.shape)} / "
                         f"{tuple(ck.shape)}")
    B, tq, H, D = q.shape
    if cv.shape != ck.shape:
        raise ValueError(f"k/v pool shape mismatch: {tuple(ck.shape)} vs "
                         f"{tuple(cv.shape)}")
    KVD = ck.shape[2]
    KV = KVD // D
    if KV * D != KVD or H % KV:
        raise ValueError(f"pool minor dim {KVD} is not kv_heads*{D} with "
                         f"kv_heads dividing {H} query heads")
    if table.ndim != 2 or table.shape[0] != B:
        raise ValueError(f"table must be [B={B}, max_blocks], got "
                         f"{tuple(table.shape)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos must be [B={B}], got {tuple(pos.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("a quantized pool needs BOTH k_scale and v_scale")
    if k_scale is not None:
        if ck.dtype != torch.int8 or cv.dtype != torch.int8:
            raise ValueError(f"scales passed but pool dtype is {ck.dtype}/"
                             f"{cv.dtype}, expected int8")
        want = (ck.shape[0], ck.shape[1], KV)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(
                f"scale pool shape {tuple(k_scale.shape)}/"
                f"{tuple(v_scale.shape)} != {want} ([n_blocks, block, "
                f"kv_heads])")
    elif ck.dtype == torch.int8 or cv.dtype == torch.int8:
        raise ValueError("an int8 pool needs k_scale/v_scale")
    return B, tq, H, D, KV


def check_kernel_config(dtype: torch.dtype, head_dim: int, block: int,
                        kv_dtype: str = "") -> None:
    """Raise ``ValueError`` unless the CUDA kernel takes this model
    dtype (q's), head dim, block size and pool dtype (``kv_dtype`` ""
    = the model dtype, "int8" = s8 values with fp32 scales).  The
    wrapper checks every launch; engines call it at construction so an
    unsupported model fails before serving."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kernel takes kv_dtype {KV_DTYPES}, got "
                         f"{kv_dtype!r}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim {HEAD_DIMS}, got "
                         f"{head_dim}")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"kernel takes blocks of 1 to {MAX_BLOCK} "
                         f"tokens, got {block}")


def kv_bytes_read(pos, tq: int, block: int, kvd: int, elt: int,
                  window: Optional[int] = None, kv_heads: int = 0) -> int:
    """HBM bytes of K and V (and, with ``kv_heads``, of their fp32 int8
    scales) that attention must read for cursors ``pos`` (the bound's
    bytes): each slot's blocks from its window's first block (0 without
    a window) through the block of its last query position.  The kernel
    reads them once while ``G * tq <= 64`` and ``ceil(G * tq / 64)``
    times beyond."""
    total = 0
    for p in (int(x) for x in pos):
        hi = (p + tq - 1) // block
        lo = max(p - window + 1, 0) // block if window else 0
        total += (hi - lo + 1) * block * (kvd * 2 * elt + 2 * 4 * kv_heads)
    return total


def paged_attention_reference(q, ck, cv, table, pos, *, k_scale=None,
                              v_scale=None, window: Optional[int] = None):
    """Plain PyTorch version: gather every slot's blocks into a dense
    row (up to the largest cursor's block), then a masked softmax with
    the kernel's rounding points — ``q * D**-0.5`` rounded to q's dtype,
    fp32 scores (times the K scale, before the mask, for an int8 pool)
    and softmax statistics, ``l`` summed before the V scale, ``p`` times
    the V scale (0 on masked keys) rounded to q's dtype before the PV
    product, output ``acc / max(l, 1e-30)``."""
    B, tq, H, D, KV = _check_shapes(q, ck, cv, table, pos, k_scale,
                                    v_scale)
    quant = k_scale is not None
    G = H // KV
    bs = ck.shape[1]
    nb = min(int(((pos.max() + tq - 1) // bs).item()) + 1, table.shape[1])
    idx = table[:, :nb].long()
    S = nb * bs
    # s8 widened to q's dtype (exact), as the kernel stages it
    k = ck[idx].reshape(B, S, KV, D).to(q.dtype).to(torch.float32)
    v = cv[idx].reshape(B, S, KV, D).to(q.dtype).to(torch.float32)
    qs = (q * D ** -0.5).to(q.dtype).to(torch.float32)
    qg = qs.view(B, tq, KV, G, D)
    scores = torch.einsum("bikgd,bskd->bkgis", qg, k)     # [B, KV, G, tq, S]
    if quant:
        ksc = k_scale[idx].reshape(B, S, KV).permute(0, 2, 1)
        scores = scores * ksc[:, :, None, None, :].to(torch.float32)
    c = torch.arange(S, device=q.device)
    qpos = pos.long()[:, None] + torch.arange(tq, device=q.device)[None]
    valid = c[None, None, :] <= qpos[:, :, None]          # [B, tq, S]
    if window is not None:
        valid = valid & (c[None, None, :] > qpos[:, :, None] - window)
    vmask = valid[:, None, None]                          # [B, 1, 1, tq, S]
    scores = scores.masked_fill(~vmask, -1e30)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    if quant:
        vsc = v_scale[idx].reshape(B, S, KV).permute(0, 2, 1)
        p = p * torch.where(vmask, vsc[:, :, None, None, :].to(
            torch.float32), 0.0)
    pr = p.to(q.dtype).to(torch.float32)
    out = torch.einsum("bkgis,bskd->bkgid", pr, v) / den
    return out.permute(0, 3, 1, 2, 4).reshape(B, tq, H, D).to(q.dtype)


def paged_attention(q, ck, cv, table, pos, *, k_scale=None, v_scale=None,
                    window: Optional[int] = None):
    """Fused paged attention (see the module docstring), fp pools or
    int8 pools with ``k_scale``/``v_scale``.  CPU tensors run
    :func:`paged_attention_reference`; CUDA tensors launch the
    hand-written kernel — building it on first use — or raise."""
    global launches, plain_calls
    B, tq, H, D, KV = _check_shapes(q, ck, cv, table, pos, k_scale,
                                    v_scale)
    quant = k_scale is not None
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not _build.on_cuda("paged_attention", q, ck, cv, table, pos,
                          k_scale, v_scale):
        plain_calls += 1
        return paged_attention_reference(q, ck, cv, table, pos,
                                         k_scale=k_scale, v_scale=v_scale,
                                         window=window)
    bs = ck.shape[1]
    check_kernel_config(q.dtype, D, bs, "int8" if quant else "")
    if not quant and (ck.dtype != q.dtype or cv.dtype != q.dtype):
        raise ValueError(f"pool dtype {ck.dtype}/{cv.dtype} != q dtype "
                         f"{q.dtype}")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError("k_scale/v_scale must be float32")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"table/pos must be int32, got {table.dtype}/"
                         f"{pos.dtype}")
    for name, t in (("q", q), ("ck", ck), ("cv", cv), ("table", table),
                    ("pos", pos), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.bps_paged_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, tq, H, KV, D, bs,
        table.shape[1], window or 0, 0 if q.dtype == torch.float32 else 1,
        int(quant), D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out


def paged_attention_sharded(q, ck, cv, table, pos, *, k_scale=None,
                            v_scale=None, window: Optional[int] = None):
    """:func:`paged_attention` over tensor-parallel per-shard pools ``ck/cv
    [tp, n_blocks, block, (KV/tp)*D]`` (int8: scale pools ``[tp,
    n_blocks, block, KV/tp]``) — the counterpart of JAX
    ``paged_decode_attention_sharded``.  Shard ``s`` holds KV heads
    ``[s*KV/tp, (s+1)*KV/tp)``, which are exactly the KV heads of query
    heads ``[s*H/tp, (s+1)*H/tp)``: one call per shard on that head
    slice (made contiguous), the outputs concatenated on the head axis.
    Each shard's launch does, row for row, the arithmetic of the
    unsharded launch (one CTA per (KV head, slot) either way), so the
    result is the unsharded one.  The table and cursors are shared by
    every shard; all shards live on one device."""
    if q.ndim != 4 or ck.ndim != 4:
        raise ValueError(f"want q [B, tq, H, D] and per-shard pools [tp, "
                         f"n_blocks, block, (KV/tp)*D], got "
                         f"{tuple(q.shape)} / {tuple(ck.shape)}")
    if cv.shape != ck.shape:
        raise ValueError(f"k/v pool shape mismatch: {tuple(ck.shape)} vs "
                         f"{tuple(cv.shape)}")
    tp, H = ck.shape[0], q.shape[2]
    if H % tp:
        raise ValueError(f"tp ({tp}) must divide num_heads ({H})")
    Hs = H // tp
    quant = k_scale is not None
    outs = [paged_attention(
        q[:, :, s * Hs:(s + 1) * Hs].contiguous(), ck[s], cv[s], table, pos,
        k_scale=k_scale[s] if quant else None,
        v_scale=v_scale[s] if quant else None, window=window)
        for s in range(tp)]
    return torch.cat(outs, dim=2)
