"""Paged-attention decode: block-table-indexed KV reads on Hopper.

Replaces the TPU kernel ``byteps_tpu/ops/paged_attention.py:76``
``_paged_kernel`` (its ``pallas_call`` at ``:286``, wrapper
``paged_decode_attention`` at ``:165``) in fp mode at tp=1.  The kernel
is hand-written CUDA C++ (``byteps_tpu_torch/csrc/paged_attention.cu``),
compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/byteps_tpu_torch/`` as a shared library with a plain C
interface (``ops/_build.py``), and bound here with ``ctypes``.

What it computes (the counterpart of ``paged_decode_attention``):
``q [B, tq, H, D]`` against flat pools ``ck/cv [n_blocks, block, KV*D]``
through ``table [B, max_blocks]`` (int32, unallocated entries = the null
block) at per-slot cursors ``pos [B]`` (int32), with an optional causal
``window``.  Query row ``(i, h)`` attends key ``c`` iff ``c <= pos + i``
(and ``c > pos + i - window``); head ``h`` reads KV head ``h // (H/KV)``.
Only the blocks that hold a readable key are read, so the null block's
padding never is.  Output ``[B, tq, H, D]`` in q's dtype.

What bounds it: HBM bytes — ``sum_b ceil((pos_b + tq) / block) * block
* KV * D * 2 * elt`` — at about 2 FLOPs per byte.  The design (one CTA
per (KV head, slot), one warp per query row, each KV block staged once
in shared memory for the whole GQA group) is set out in the CUDA
source, with what it leaves for later (split-K, TMA, wgmma).

Beside the kernel:

* :func:`paged_attention_reference` — the plain PyTorch version: gather
  each slot's blocks into a dense row, masked softmax, with the kernel's
  rounding points.  The CPU tests use it; ``chip_smoke.py`` holds the
  kernel against it on the card.
* :func:`paged_attention` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise.  There is no
  fallback from a failed build or launch.
* ``launches`` — kernel launches made by the wrapper (a plain integer);
  ``plain_calls`` — dispatches to the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_reference", "build",
           "check_kernel_config", "kv_bytes_read", "launches",
           "plain_calls", "HEAD_DIMS"]

launches = 0
plain_calls = 0

MAX_BLOCK = 64
HEAD_DIMS = (16, 32, 64, 128)
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
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
        _lib = lib
    return _lib


def _check_shapes(q, ck, cv, table, pos):
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
    return B, tq, H, D, KV


def check_kernel_config(dtype: torch.dtype, head_dim: int,
                        block: int) -> None:
    """Raise ``ValueError`` unless the CUDA kernel takes this dtype, head
    dim and block size.  The wrapper checks every launch; engines call
    it at construction so an unsupported model fails before serving."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim {HEAD_DIMS}, got "
                         f"{head_dim}")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"kernel takes blocks of 1 to {MAX_BLOCK} "
                         f"tokens, got {block}")


def kv_bytes_read(pos, tq: int, block: int, kvd: int, elt: int,
                  window: Optional[int] = None) -> int:
    """HBM bytes of K and V that attention must read for cursors
    ``pos`` (the bound's bytes): each slot's blocks from its window's
    first block (0 without a window) through the block of its last
    query position.  The kernel reads them once while ``G * tq <= 64``
    and ``ceil(G * tq / 64)`` times beyond."""
    total = 0
    for p in (int(x) for x in pos):
        hi = (p + tq - 1) // block
        lo = max(p - window + 1, 0) // block if window else 0
        total += (hi - lo + 1) * block * kvd * 2 * elt
    return total


def paged_attention_reference(q, ck, cv, table, pos,
                              window: Optional[int] = None):
    """Plain PyTorch version: gather every slot's blocks into a dense
    row (up to the largest cursor's block), then a masked softmax with
    the kernel's rounding points — ``q * D**-0.5`` rounded to q's dtype,
    fp32 scores and softmax statistics, ``p`` rounded to v's dtype
    before the PV product, output ``acc / max(l, 1e-30)``."""
    B, tq, H, D, KV = _check_shapes(q, ck, cv, table, pos)
    G = H // KV
    bs = ck.shape[1]
    nb = min(int(((pos.max() + tq - 1) // bs).item()) + 1, table.shape[1])
    idx = table[:, :nb].long()
    S = nb * bs
    k = ck[idx].reshape(B, S, KV, D).to(torch.float32)
    v = cv[idx].reshape(B, S, KV, D)
    qs = (q * D ** -0.5).to(q.dtype).to(torch.float32)
    qg = qs.view(B, tq, KV, G, D)
    scores = torch.einsum("bikgd,bskd->bkgis", qg, k)     # [B, KV, G, tq, S]
    c = torch.arange(S, device=q.device)
    qpos = pos.long()[:, None] + torch.arange(tq, device=q.device)[None]
    valid = c[None, None, :] <= qpos[:, :, None]          # [B, tq, S]
    if window is not None:
        valid = valid & (c[None, None, :] > qpos[:, :, None] - window)
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    pr = p.to(v.dtype).to(torch.float32)
    out = torch.einsum("bkgis,bskd->bkgid", pr, v.to(torch.float32)) / den
    return out.permute(0, 3, 1, 2, 4).reshape(B, tq, H, D).to(q.dtype)


def paged_attention(q, ck, cv, table, pos, *, window: Optional[int] = None):
    """Fused paged attention (see the module docstring).  CPU tensors
    run :func:`paged_attention_reference`; CUDA tensors launch the
    hand-written kernel — building it on first use — or raise."""
    global launches, plain_calls
    B, tq, H, D, KV = _check_shapes(q, ck, cv, table, pos)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    devices = {t.device for t in (q, ck, cv, table, pos)}
    if all(d.type == "cpu" for d in devices):
        plain_calls += 1
        return paged_attention_reference(q, ck, cv, table, pos,
                                         window=window)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"paged_attention needs every tensor on one CUDA "
                         f"device (or all on the CPU), got {devices}")
    bs = ck.shape[1]
    check_kernel_config(q.dtype, D, bs)
    if ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise ValueError(f"pool dtype {ck.dtype}/{cv.dtype} != q dtype "
                         f"{q.dtype}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"table/pos must be int32, got {table.dtype}/"
                         f"{pos.dtype}")
    for name, t in (("q", q), ("ck", ck), ("cv", cv), ("table", table),
                    ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.bps_paged_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, tq, H, KV, D, bs,
        table.shape[1], window or 0, 0 if q.dtype == torch.float32 else 1,
        D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out
