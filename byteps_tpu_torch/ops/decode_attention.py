"""Decode attention — one query token against a flat KV cache — as a
hand-written Hopper kernel, fp or int8.

Replaces the TPU kernel ``byteps_tpu/ops/decode_attention.py:71``
``_decode_kernel`` (its ``pallas_call`` at ``:277``, wrapper
``decode_attention`` at ``:161``) in both its fp and its int8 mode.  The
kernel is CUDA C++ (``byteps_tpu_torch/csrc/decode_attention.cu``),
compiled with ``nvcc`` for ``sm_90a`` at first use (``ops/_build.py``)
and bound here with ``ctypes``.

What it computes (the counterpart of ``decode_attention``): ``q [B, 1,
H, D]`` at the absolute position ``pos`` — one host ``int`` for every
row, or a ``[B]`` int32 tensor on q's device, one position a row, which
the kernel reads itself (the JAX kernel's scalar prefetch; the dense
serving engine's decode tick, whose slots sit at different depths) —
against caches ``ck/cv [B, S,
KV*D]`` (a grouped ``[B, S, KV, D]`` cache is viewed flat, which is free
for a contiguous tensor), fp32/bf16 like q, or int8 with ``k_scale /
v_scale [B, S, KV]`` fp32 (``_quantize_kv``'s per-(position, head)
scales).  Head ``h`` reads KV head ``h // (H/KV)``; key ``c`` of row ``b`` is
attended iff ``c <= pos[b]`` (and ``c > pos[b] - window``).  Output ``[B, 1,
H, D]`` in q's dtype.  The TPU wrapper's block-diagonal query and
one-hot contraction feed the MXU and are not ported: the CUDA kernel
shares each staged K/V chunk across the query heads of its KV head.

What bounds it: HBM bytes — :func:`kv_bytes_read`, the K/V rows (and
int8 scales) of the attended keys — at about ``2 G / elt`` FLOPs per
byte.  Two designs, set out in the CUDA source, chosen by one rule
(:func:`_ring_ok`, which the C side checks): a bf16 q with at most 32
query heads a KV head takes the kernel on tensor cores — chunks of 64
keys streamed through a ``cp.async`` ring, a few long splits
(:func:`_splits`) merged inside the same launch by the last CTA of each
(slot, KV head) through a cached ticket buffer; an fp32 q (and wider
groups) keeps the first design, flash-decoding over many short splits
merged by a small combine kernel.  With device positions the split plan
is sized from shapes alone (:func:`_max_chunks`: the longest row the cache
and window allow), each CTA derives its slot's chunks from ``pos[b]``, and
a split past them writes an empty partial, so a slot's output bits do not
depend on the other slots' positions; the wrapper never reads the vector.

Beside the kernel:

* :func:`decode_attention_reference` — the plain PyTorch version: dense
  masked softmax over the rows ``<= pos`` with the kernel's rounding
  points.  The CPU tests use it; ``chip_smoke.py`` holds the kernel
  against it on the card.
* :func:`decode_attention` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise.  No fallback.
* :func:`decode_attention_usable` — the port's copy of the JAX gate
  (``decode_attention.py:297``) that ``init_cache(layout="auto")`` reads.
* ``launches`` — calls that launched a kernel; ``design_launches`` —
  the kernels the library reports launching, by design (``ring``,
  ``first``, ``combine``: the first design's merge, where it splits) and
  ``device_pos`` (launches that read a position vector); every call is
  held to the counts :func:`_kernels_for` predicts.  ``plain_calls`` —
  dispatches to the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
import numbers
from typing import Dict, Optional

import torch

from . import _build

__all__ = ["decode_attention", "decode_attention_reference",
           "decode_attention_usable", "check_kernel_config",
           "kv_bytes_read", "decode_flops",
           "build", "HEAD_DIMS", "CHUNK"]

COUNTS = ("ring", "first", "combine", "device_pos")  # the C side's order
launches = 0
plain_calls = 0
design_launches = dict.fromkeys(COUNTS, 0)

HEAD_DIMS = (16, 32, 64, 128)
CHUNK = 64             # keys per chunk of the kernel
RING_MAX_GROUP = 32    # query heads a KV head the ring design takes
RING_MIN_CHUNKS = 8    # chunks a ring split streams, where the cache has them
_SMEM_LIMIT = 232448   # bytes of shared memory one Hopper block may use
_lib = None
_tickets: Dict[torch.device, torch.Tensor] = {}


def build():
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    return _build.build(["decode_attention"])["decode_attention"]


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bps_decode_attention.argtypes = (
            [p] * 8 + [i] * 12 + [ctypes.c_float, p, p, p])
        lib.bps_decode_attention.restype = i
        lib.bps_decode_attention_smem.argtypes = [i, i, i, i, i]
        lib.bps_decode_attention_smem.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _check(q, ck, cv, pos, k_scale, v_scale, window):
    """Validate shapes and options; returns ``(B, S, H, KV, D, quant)``
    and the caches viewed flat."""
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention is tq=1 only: want q [B, 1, H, "
                         f"D], got {tuple(q.shape)}")
    B, _, H, D = q.shape
    if ck.shape != cv.shape or ck.ndim not in (3, 4):
        raise ValueError(f"want caches [B, S, KV*D] or [B, S, KV, D] of one "
                         f"shape, got {tuple(ck.shape)} / {tuple(cv.shape)}")
    S = ck.shape[1]
    if ck.ndim == 4:
        if ck.shape[3] != D:
            raise ValueError(f"cache head dim {ck.shape[3]} != q's {D}")
        ck = ck.reshape(B, S, -1)
        cv = cv.reshape(B, S, -1)
    KV = ck.shape[2] // D
    if ck.shape[0] != B or KV * D != ck.shape[2] or KV < 1 or H % KV:
        raise ValueError(f"cache {tuple(ck.shape)} is not [B={B}, S, "
                         f"kv_heads*{D}] with kv_heads dividing {H}")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if quant:
        for n, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(s.shape) != (B, S, KV):
                raise ValueError(f"{n} must be [B, S, KV]={(B, S, KV)}, got "
                                 f"{tuple(s.shape)}")
        if ck.dtype != torch.int8 or cv.dtype != torch.int8:
            raise ValueError(f"scales mark an int8 cache, got {ck.dtype}/"
                             f"{cv.dtype}")
    if isinstance(pos, torch.Tensor):
        if (tuple(pos.shape) != (B,) or pos.dtype != torch.int32
                or pos.device != q.device):
            raise ValueError(f"a position vector must be [B={B}] int32 on "
                             f"{q.device}, got {tuple(pos.shape)} "
                             f"{pos.dtype} on {pos.device}")
    elif not 0 <= pos < S:
        raise ValueError(f"pos {pos} outside the {S}-row cache")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return (B, S, H, KV, D, quant), ck, cv


def _first_key(pos: int, window: Optional[int]) -> int:
    return max(pos - window + 1, 0) if window else 0


def _rows(B: int, pos, window: Optional[int]) -> int:
    """Attended keys summed over the rows: ``pos`` one int for all ``B``
    rows, or one position a row."""
    if isinstance(pos, numbers.Integral):
        return B * (pos - _first_key(pos, window) + 1)
    return sum(p - _first_key(p, window) + 1 for p in map(int, pos))


def kv_bytes_read(B: int, pos, kvd: int, elt: int,
                  window: Optional[int] = None, kv_heads: int = 0) -> int:
    """HBM bytes of K and V (and, with ``kv_heads``, of their fp32
    int8 scales) that attention at ``pos`` (an int, or one position a
    row) must read: every slot's rows from the window's first key (0
    without one) through its position — the bound's bytes.  The kernel
    reads no other cache row."""
    return _rows(B, pos, window) * (2 * kvd * elt + 2 * 4 * kv_heads)


def decode_flops(B: int, H: int, D: int, pos,
                 window: Optional[int] = None) -> int:
    """FLOPs of one call: QK and PV over the attended keys."""
    return 4 * H * D * _rows(B, pos, window)


def check_kernel_config(dtype: torch.dtype, head_dim: int) -> None:
    """Raise ``ValueError`` unless the CUDA kernel takes this q dtype and
    head dim.  The wrapper checks every launch; a dense engine on a flat
    cache calls it at construction, so an unsupported model fails before
    serving (never by switching to the grouped path)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim {HEAD_DIMS}, got "
                         f"{head_dim}")


def decode_attention_usable(q_shape, cache_len: int, quant_cache: bool,
                            kv_heads: Optional[int] = None) -> bool:
    """The JAX gate (``decode_attention.py:297``): tq = 1, and for an int8
    cache MHA only (``kv_heads == H``; a GQA int8 cache keeps the dense
    grouped path, as in JAX).  The last condition is the TPU kernel's
    accumulator limit, kept so both packages choose the same layout."""
    B, tq, H, D = q_shape
    if tq != 1:
        return False
    if quant_cache and (kv_heads is None or kv_heads != H):
        return False
    Hp = -(-H // 16) * 16
    return Hp * H * D * 4 < 4 * 1024 * 1024


def decode_attention_reference(q, ck, cv, pos, *, k_scale=None,
                               v_scale=None, window: Optional[int] = None):
    """Plain PyTorch version: a dense masked softmax over the rows from
    the window's first key through ``pos`` with the kernel's rounding
    points — ``q * D**-0.5`` rounded to q's dtype, fp32 scores (times the
    K scale for an int8 cache) and softmax statistics, ``l`` summed before
    the V scale, ``p`` times the V scale rounded to q's dtype before the
    PV product, output ``acc / max(l, 1e-30)``.  A position vector runs
    the rows of each position as one call at that position (reading the
    vector back: this version never runs on a CUDA path), so equal
    positions are the int call, bit for bit."""
    (B, S, H, KV, D, quant), ck, cv = _check(q, ck, cv, pos, k_scale,
                                             v_scale, window)
    if isinstance(pos, torch.Tensor):
        rows = pos.tolist()
        out = torch.empty_like(q)
        for p in sorted(set(rows)):
            sel = torch.tensor([b for b, r in enumerate(rows) if r == p],
                               device=q.device)

            def take(t):
                return None if t is None else t[sel]
            out[sel] = decode_attention_reference(
                q[sel], ck[sel], cv[sel], p, k_scale=take(k_scale),
                v_scale=take(v_scale), window=window)
        return out
    G = H // KV
    wt = _build.wide_dtype(q)
    lo = _first_key(pos, window)
    k = ck[:, lo:pos + 1].reshape(B, -1, KV, D).to(wt)    # [B, n, KV, D]
    v = cv[:, lo:pos + 1].reshape(B, -1, KV, D).to(wt)
    qs = (q[:, 0] * D ** -0.5).to(q.dtype).to(wt).view(B, KV, G, D)
    s = torch.einsum("bkgd,bnkd->bkgn", qs, k)              # [B, KV, G, n]
    if quant:
        s = s * k_scale[:, lo:pos + 1].permute(0, 2, 1)[:, :, None].to(wt)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    if quant:
        p = p * v_scale[:, lo:pos + 1].permute(0, 2, 1)[:, :, None].to(wt)
    # p in v's dtype for the PV product (q's for an int8 cache, whose
    # values are widened to it)
    p = p.to(q.dtype if quant else cv.dtype).to(wt)
    out = torch.einsum("bkgn,bnkd->bkgd", p, v) / den
    return out.reshape(B, 1, H, D).to(q.dtype)


def _ring_ok(dtype: torch.dtype, group: int) -> bool:
    """Whether a call takes the design on tensor cores (the C side's
    ``ring_ok``, which refuses any other ring launch): a bf16 q (with a
    bf16 or int8 cache) and at most :data:`RING_MAX_GROUP` query heads a
    KV head.  An fp32 q keeps the first design."""
    return dtype == torch.bfloat16 and group <= RING_MAX_GROUP


def _max_chunks(S: int, window: Optional[int]) -> int:
    """The most chunks one row of an ``S``-row cache can attend: all of
    them, or under a window of ``w`` keys the ``(w + 62) // 64 + 1`` a
    misaligned window touches.  The device form's plan covers this many,
    whatever the positions are."""
    n = -(-S // CHUNK)
    return min(n, (window + CHUNK - 2) // CHUNK + 1) if window else n


def _kernels_for(ring: bool, nsplit: int, device_pos: bool) -> list:
    """The library's counts (:data:`COUNTS`) one call must report: one
    ring launch, or the first design's kernel and, where it splits, its
    combine kernel; and one launch reading the position vector in the
    device form."""
    return [int(ring), int(not ring), int(not ring and nsplit > 1),
            int(device_pos)]


def _splits(B: int, KV: int, n_chunks: int, sms: int, ring: bool) -> tuple:
    """``(splits, chunks per split)`` over the ``n_chunks`` attended
    chunks, none of them empty; a pure function of shapes (and, through
    ``n_chunks``, of an int ``pos``; the device form passes
    :func:`_max_chunks`, and a split past a short row's chunks is then
    empty).  Ring design: about one CTA an SM, each
    split at least :data:`RING_MIN_CHUNKS` chunks where the cache has
    them, so its ring streams (B = 8, KV = 8, 2048 keys: 2 splits of 16).
    First design: enough splits to put about eight CTAs on every SM (a
    CTA has one chunk's loads in flight at a time)."""
    if ring:
        want = max(1, sms // (B * KV))
        k = min(want, max(1, n_chunks // RING_MIN_CHUNKS))
    else:
        k = min(max(1, math.ceil(8 * sms / (B * KV))), n_chunks)
    per = math.ceil(n_chunks / k)
    return math.ceil(n_chunks / per), per


def _ticket_buffer(device, n: int) -> torch.Tensor:
    """``n`` int32 zeros on ``device``, allocated once (grown when a call
    needs more): the ring kernel's per-(slot, KV head) merge tickets,
    which each launch leaves at zero."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = _tickets[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                             device=device)
    return buf


def decode_attention(q, ck, cv, pos, *, k_scale=None, v_scale=None,
                     window: Optional[int] = None):
    """Single-step cached attention (see the module docstring).  ``pos``
    is an int, or a ``[B]`` int32 tensor on q's device.  CPU tensors run
    :func:`decode_attention_reference`; CUDA tensors launch the
    hand-written kernel — building it on first use — or raise."""
    global launches, plain_calls
    device_pos = isinstance(pos, torch.Tensor)
    if not device_pos:
        pos = int(pos)
    (B, S, H, KV, D, quant), ckf, cvf = _check(q, ck, cv, pos, k_scale,
                                               v_scale, window)
    if not _build.on_cuda("decode_attention", q, ck, cv, k_scale, v_scale,
                          pos if device_pos else None):
        plain_calls += 1
        return decode_attention_reference(q, ck, cv, pos, k_scale=k_scale,
                                          v_scale=v_scale, window=window)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim {HEAD_DIMS}, got {D}")
    if not quant and (ck.dtype != q.dtype or cv.dtype != q.dtype):
        raise ValueError(f"cache dtype {ck.dtype}/{cv.dtype} != q dtype "
                         f"{q.dtype} (an int8 cache needs its scales)")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError("k_scale/v_scale must be float32")
    for name, t in (("q", q), ("ck", ckf), ("cv", cvf), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned, got shape {tuple(t.shape)} strides "
                             f"{t.stride()} at offset {t.data_ptr() % 16}")
    if device_pos and not pos.is_contiguous():
        raise ValueError("the position vector must be contiguous")
    lib = _library()
    dtype = int(q.dtype == torch.bfloat16)
    ring = _ring_ok(q.dtype, H // KV)
    smem = lib.bps_decode_attention_smem(H // KV, D, dtype, int(quant),
                                         int(ring))
    if not 0 < smem <= _SMEM_LIMIT:
        raise ValueError(f"{H // KV} query heads per KV head at head_dim {D} "
                         f"need {smem} bytes of shared memory (> "
                         f"{_SMEM_LIMIT})")
    # the plan; each CTA derives its slot's chunks itself.  The device
    # form plans for the longest row: no value of pos is read
    n_chunks = (_max_chunks(S, window) if device_pos
                else pos // CHUNK - _first_key(pos, window) // CHUNK + 1)
    nsplit, per = _splits(B, KV, n_chunks, _build.sm_count(q.device), ring)
    out = torch.empty_like(q)
    part = tickets = None
    if nsplit > 1:
        # m and l [nsplit, B, H], then acc [nsplit, B, H, D]
        part = torch.empty(nsplit * B * H * (D + 2), dtype=torch.float32,
                           device=q.device)
        if ring:
            tickets = _ticket_buffer(q.device, B * KV)

    def ptr(t):
        return None if t is None else t.data_ptr()

    counts = (ctypes.c_int * len(COUNTS))()
    rc = lib.bps_decode_attention(
        q.data_ptr(), ckf.data_ptr(), cvf.data_ptr(), ptr(k_scale),
        ptr(v_scale), out.data_ptr(), ptr(part), ptr(tickets), B, S, H, KV,
        D, 0 if device_pos else pos, window or 0, nsplit, per, dtype,
        int(quant), int(ring), D ** -0.5,
        pos.data_ptr() if device_pos else None, counts,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {rc}")
    took, want = list(counts), _kernels_for(ring, nsplit, device_pos)
    if took != want:
        raise RuntimeError(f"decode_attention: the library launched {took} "
                           f"kernels by {COUNTS}, the rule predicted {want}")
    for name, n in zip(COUNTS, took):
        design_launches[name] += n
    launches += 1
    return out
