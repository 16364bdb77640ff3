"""Decoder-only Transformer — the port of ``byteps_tpu/models/transformer.py``
for paged serving, cached generation and the single-process training
step.

What is carried over, by JAX counterpart:

* ``TransformerConfig`` — the architecture fields plus ``causal`` and
  ``attn_impl`` (``"local"`` or ``"flash"``; the mesh axes and the
  ``"ring"``/``"ulysses"`` sequence-parallel impls are later slices);
* ``apply_rope`` + ``_scaled_inv_freq`` — fp32 angles, HF half-split
  rotation, llama3 / linear frequency rescale;
* RMSNorm / LayerNorm with flax's numerics (statistics and the scale
  multiply in fp32, fast variance for LayerNorm, result cast to the
  model dtype);
* ``MLP`` — swiglu, or gelu with the tanh approximation (flax's
  ``nn.gelu`` default);
* ``QuantDense`` as :class:`Dense`: float weights cast at use, or after
  ``inference.quantize_params`` int8 weights with fp32 scales through
  the int8 product kernel of ``ops/quant_dot.py``;
* ``Attention`` — the no-cache training branch (``"flash"``: the
  hand-written kernels of ``ops/flash_attention.py``, a key mask riding
  their segment ids; ``"local"``: :func:`local_attention`, the plain
  masked softmax with GQA repeated), the fused paged branch (fresh K/V
  scattered into the flat block pool at ``(wblk, woff)``, then the
  kernel of ``ops/paged_attention.py``) and the cached branch over
  ``init_cache``'s flat or grouped, fp or int8 caches (``_quantize_kv``;
  decode through the kernel of ``ops/decode_attention.py`` on a flat
  cache; flash prefill; ``_cached_attention`` / ``_cached_attention_q8``
  otherwise), dispatched as the JAX ``Attention``;
* ``Transformer`` with ``hidden`` / ``forward`` (training), ``decode``
  (at one offset, or at one position a row — the JAX ``decode`` under the
  dense serving engine's ``vmap``), ``verify_tokens``, ``prefill_chunk``,
  ``prefill_chunk_paged``, ``decode_paged_fused``, the gather fallback's
  ``decode_paged`` / ``verify_tokens_paged`` (every slot's rows gathered
  in one batch, ``gather_paged_rows``, and written back,
  ``scatter_paged_rows``), ``logits`` (fp32 logits, the head accumulated
  in fp32 from model-dtype operands) and ``head_weight`` (the head in the model dtype,
  for the fused LM-head cross-entropy).

Parameters are kept in ``param_dtype`` (fp32 by default, as flax's
``param_dtype=float32``) and cast to ``cfg.dtype`` where they are used,
so an optimizer updates fp32 weights while the products run in bf16.
Serving may build the model with ``param_dtype=cfg.dtype``: the casts
are then no-ops, the weights take half the memory, and the decode tick
launches no cast kernels — the same numerics, since a bf16 weight cast
to bf16 is itself.

PyTorch idiom where JAX was functional: the KV pools and cache rows are
updated IN PLACE where the JAX code returns updated copies of donated
buffers, and ``vmap`` over slots is a batch dimension written out.
Weight layouts are ``nn.Linear``'s ``[out, in]``; ``models/convert.py``
carries a JAX parameter tree across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decode_attention import decode_attention, decode_attention_usable
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_attention, paged_attention_sharded
from ..ops.quant_dot import quant_linear, quantize_weight

__all__ = ["TransformerConfig", "Transformer", "apply_rope",
           "gather_paged_rows", "scatter_paged_rows", "init_cache",
           "init_weights", "local_attention", "ATTN_IMPLS", "CACHE_LAYOUTS"]

ATTN_IMPLS = ("local", "flash")
CACHE_LAYOUTS = ("auto", "flat", "grouped")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 4
    num_heads: int = 8
    # GQA/MQA: shared K/V heads (None = num_heads, i.e. MHA)
    num_kv_heads: Optional[int] = None
    d_model: int = 512
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    causal: bool = True  # False => bidirectional encoder (BERT-style)
    # training attention: "local" (plain masked softmax) or "flash" (the
    # hand-written kernels); "ring"/"ulysses" need the sp axis (later)
    attn_impl: str = "local"
    # causal sliding window (flash, paged and dense-cached paths)
    attn_window: Optional[int] = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    use_bias: bool = False
    tie_embeddings: bool = False
    pos_emb: str = "learned"  # learned | rope | none
    rope_theta: float = 10000.0
    # HF rope_scaling as a tuple of sorted (key, value) pairs
    rope_scaling: Optional[tuple] = None
    head_dim: Optional[int] = None
    mlp: str = "gelu"  # gelu | swiglu

    @property
    def d_head(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.num_heads)

    @property
    def kv_heads(self) -> int:
        kv = self.num_kv_heads
        if kv is None:
            return self.num_heads
        if kv < 1 or self.num_heads % kv:
            raise ValueError(
                f"num_kv_heads {kv} must divide num_heads {self.num_heads}")
        return kv


# ------------------------------------------------------------------ rope


def _scaled_inv_freq(inv_freq: torch.Tensor, scaling) -> torch.Tensor:
    """Frequency rescaling for long-context RoPE variants (HF
    ``_compute_llama3_parameters`` / linear scaling), in fp32."""
    s = dict(scaling)
    rt = s.get("rope_type", s.get("type", "default"))
    if rt in (None, "default"):
        return inv_freq
    factor = float(s.get("factor", 1.0))
    if rt == "linear":
        return inv_freq / factor
    if rt == "llama3":
        low = float(s.get("low_freq_factor", 1.0))
        high = float(s.get("high_freq_factor", 4.0))
        orig = float(s.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (orig / wavelen - low) / (high - low)
        smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
        return torch.where(
            wavelen < orig / high, inv_freq,
            torch.where(wavelen > orig / low, scaled, smoothed))
    raise ValueError(f"unsupported rope_scaling type {rt!r}")


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, scaling=None) -> torch.Tensor:
    """Rotary embedding, HF half-split convention: ``x [B, T, H, D]``
    rotated by ``pos / theta^(2i/D)``; ``positions`` is ``[T]`` or
    ``[B, T]`` (per-slot cursors of the fused paged step).  Computed in
    fp32 and cast back."""
    D = x.shape[-1]
    half = D // 2
    inv_freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                             device=x.device) / half))
    if scaling is not None:
        inv_freq = _scaled_inv_freq(inv_freq, scaling)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    if ang.ndim == 2:                      # [T, D/2] -> broadcast batch
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]    # [1|B, T, 1, D/2]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------ dense attention


def _group_q(q: torch.Tensor, KV: int) -> torch.Tensor:
    """``[B, tq, H, D] -> [B, KV, G*tq, D]`` (group-major, query-position
    minor): cached GQA attention as two batched products against the
    un-repeated cache."""
    B, tq, H, D = q.shape
    G = H // KV
    return (q.reshape(B, tq, KV, G, D).permute(0, 2, 3, 1, 4)
            .reshape(B, KV, G * tq, D))


def _ungroup_o(o: torch.Tensor, tq: int) -> torch.Tensor:
    """Inverse of ``_group_q``: ``[B, KV, G*tq, D] -> [B, tq, KV*G, D]``."""
    B, KV, GT, D = o.shape
    G = GT // tq
    return (o.reshape(B, KV, G, tq, D).permute(0, 3, 1, 2, 4)
            .reshape(B, tq, KV * G, D))


def _grouped_mask(S: int, G: int, qpos: torch.Tensor,
                  window: Optional[int]) -> torch.Tensor:
    """Causal (+ window) keep-mask ``[1|B, 1, G*tq, S]`` in ``_group_q``'s
    row order, from the queries' absolute positions ``qpos [1|B, tq]``
    (one row for all, or one a row)."""
    kidx = torch.arange(S, device=qpos.device)[None, None, None, :]
    qidx = qpos.repeat(1, G)[:, None, :, None]
    mask = kidx <= qidx
    if window is not None:
        mask = mask & (kidx > qidx - window)
    return mask


def _cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      qpos: torch.Tensor,
                      window: Optional[int] = None) -> torch.Tensor:
    """Dense attention of ``q [B, tq, H, D]`` at the absolute positions
    ``qpos [1|B, tq]`` (one offset for all rows, or one a row) against
    ``ck/cv [B, S, KV, D]`` (positions past the query's unwritten and
    masked).  Scores and softmax in fp32, probabilities
    cast to the model dtype before the PV product — the JAX dense
    path's rounding points.  A plain large product, as JAX leaves it to
    XLA: this runs chunk prefill only; decode takes the kernel."""
    B, tq, H, D = q.shape
    KV = ck.shape[2]
    qg = _group_q(q * D ** -0.5, KV)                     # [B, KV, GT, D]
    kt = ck.permute(0, 2, 3, 1).to(torch.float32)        # [B, KV, D, S]
    scores = torch.matmul(qg.to(torch.float32), kt)      # [B, KV, GT, S]
    mask = _grouped_mask(ck.shape[1], H // KV, qpos, window)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs, cv.permute(0, 2, 1, 3))    # [B, KV, GT, D]
    return _ungroup_o(out, tq)


def _quantize_kv(x: torch.Tensor):
    """Per-(position, head) symmetric int8 quantization of K or V ``[B,
    t, H, D]`` -> (int8 values, fp32 scales ``[B, t, H]``): ``scale =
    absmax / 127`` (1 where the row is zero), values rounded half to even
    and clipped to +-127 — the JAX ``_quantize_kv``, bit for bit."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _cached_attention_q8(q: torch.Tensor, ck: torch.Tensor,
                         ck_scale: torch.Tensor, cv: torch.Tensor,
                         cv_scale: torch.Tensor, qpos: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """Dense cached attention against an int8 grouped cache ``ck/cv [B, S,
    KV, D]`` with fp32 scales ``[B, S, KV]`` — the JAX
    ``_cached_attention_q8``'s rounding points: scores of the int8 values
    rounded to q's dtype, then times the K scale in fp32; fp32 softmax;
    probabilities times the V scale rounded to q's dtype; the PV product
    in q's dtype.  The int8 values are widened to q's dtype, which is
    exact (|q| <= 127).  A plain product: GQA int8 caches and tq > 1 take
    it; the flat int8 cache decodes through the kernel."""
    B, tq, H, D = q.shape
    KV = ck.shape[2]
    cdt = q.dtype
    qg = _group_q((q * D ** -0.5).to(cdt), KV)               # [B, KV, GT, D]
    scores = torch.matmul(qg, ck.permute(0, 2, 3, 1).to(cdt))
    scores = (scores.to(torch.float32)
              * ck_scale.permute(0, 2, 1)[:, :, None, :])
    mask = _grouped_mask(ck.shape[1], H // KV, qpos, window)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    probs = (probs * cv_scale.permute(0, 2, 1)[:, :, None, :]).to(cdt)
    out = torch.matmul(probs, cv.permute(0, 2, 1, 3).to(cdt))
    return _ungroup_o(out, tq)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain masked attention (``parallel/ring_attention.py
    local_attention``) over ``[B, T, H, D]`` with as many K/V heads as
    query heads: ``q * scale`` in q's dtype, fp32 scores, ``-inf`` masks
    (causal; ``key_mask [B, S]`` 1 = attend), softmax with fully masked
    rows set to 0, fp32 PV, cast to q's dtype.  Runs no kernel."""
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bqhk", (q * scale).float(), k.float())
    if causal:
        T, S = q.shape[1], k.shape[1]
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(S, device=q.device)[None, :])
        s = s.masked_fill(~mask[None, :, None, :], float("-inf"))
    if key_mask is not None:
        s = s.masked_fill(~key_mask.bool()[:, None, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1))
    return torch.einsum("bqhk,bkhd->bqhd", p, v.float()).to(q.dtype)


# -------------------------------------------------------------- modules


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        xf = x.to(torch.float32)
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        mul = torch.rsqrt(ms + self.eps) * self.scale
        return (xf * mul).to(self.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        xf = x.to(torch.float32)
        mean = torch.mean(xf, dim=-1, keepdim=True)
        # flax's fast variance: E[x^2] - E[x]^2, clipped at 0
        var = torch.clamp(torch.mean(xf * xf, dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def _make_norm(cfg: TransformerConfig, device):
    # norm scales (and biases) stay fp32 whatever the param dtype, as in
    # flax, whose norms keep fp32 parameters
    if cfg.norm == "layernorm":
        return LayerNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)
    if cfg.norm != "rmsnorm":
        raise ValueError(f"unknown norm {cfg.norm!r}")
    return RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, device)


class Dense(nn.Linear):
    """``nn.Linear`` whose parameters keep their own dtype and are cast
    to the compute dtype at use (the JAX ``QuantDense``: operands in
    ``dtype``, parameters in flax's fp32 ``param_dtype``).

    After :meth:`quantize` (``inference.quantize_params``) the weight is
    int8 ``[out, in]`` with an fp32 ``scale`` buffer ``[out]`` (the JAX
    ``scale`` leaf), and the forward is the int8 weight-only product of
    ``ops/quant_dot.py`` with ``QuantDense``'s rounding."""

    def __init__(self, n_in: int, n_out: int, bias: bool, dtype,
                 param_dtype, device=None):
        super().__init__(n_in, n_out, bias=bias, device=device,
                         dtype=param_dtype)
        self.cdt = dtype
        self.register_buffer("scale", None)

    @property
    def quantized(self) -> bool:
        return self.weight.dtype == torch.int8

    @torch.no_grad()
    def quantize(self) -> None:
        """Replace the weight by its per-output-channel int8 values and
        register their scales (``ops.quant_dot.quantize_weight``)."""
        if self.quantized:
            return
        q, scale = quantize_weight(self.weight)
        self.weight = nn.Parameter(q, requires_grad=False)
        self.scale = scale

    def forward(self, x, out_dtype=None):
        """``out_dtype`` (the quantized head's fp32) applies to the int8
        product only."""
        if self.quantized:
            return quant_linear(x.to(self.cdt), self.weight, self.scale,
                                self.bias, out_dtype or self.cdt)
        b = None if self.bias is None else self.bias.to(self.cdt)
        return F.linear(x.to(self.cdt), self.weight.to(self.cdt), b)


def _linear(cfg: TransformerConfig, n_in: int, n_out: int, device,
            param_dtype, bias: Optional[bool] = None) -> Dense:
    return Dense(n_in, n_out, cfg.use_bias if bias is None else bias,
                 cfg.dtype, param_dtype, device)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        H, KV, D = cfg.num_heads, cfg.kv_heads, cfg.d_head
        self.q = _linear(cfg, cfg.d_model, H * D, device, param_dtype)
        self.k = _linear(cfg, cfg.d_model, KV * D, device, param_dtype)
        self.v = _linear(cfg, cfg.d_model, KV * D, device, param_dtype)
        self.o = _linear(cfg, H * D, cfg.d_model, device, param_dtype)

    def _qkv(self, x, rpos):
        cfg = self.cfg
        B, T, _ = x.shape
        H, KV, D = cfg.num_heads, cfg.kv_heads, cfg.d_head
        q = self.q(x).view(B, T, H, D)
        k = self.k(x).view(B, T, KV, D)
        v = self.v(x).view(B, T, KV, D)
        if cfg.pos_emb == "rope":
            # rotated before the cache write: cached K is stored rotated
            q = apply_rope(q, rpos, cfg.rope_theta, cfg.rope_scaling)
            k = apply_rope(k, rpos, cfg.rope_theta, cfg.rope_scaling)
        return q, k, v

    def forward(self, x, key_mask=None):
        """The no-cache (training) branch over ``x [B, T, d_model]``:
        ``"flash"`` runs the flash kernels on grouped K/V, ``key_mask
        [B, T]`` riding their segment ids (pads see only pads, so valid
        rows match the masked softmax); ``"local"`` repeats K/V to the
        query heads and runs :func:`local_attention`."""
        cfg = self.cfg
        B, T, _ = x.shape
        q, k, v = self._qkv(x, torch.arange(T, device=x.device))
        if cfg.attn_impl == "flash":
            out = flash_attention(q, k, v, causal=cfg.causal,
                                  segment_ids=key_mask,
                                  window=cfg.attn_window)
        else:
            if cfg.attn_window is not None:
                raise ValueError("attn_window requires attn_impl='flash' "
                                 f"(got {cfg.attn_impl!r})")
            G = cfg.num_heads // cfg.kv_heads
            if G > 1:
                k = k.repeat_interleave(G, dim=2)
                v = v.repeat_interleave(G, dim=2)
            out = local_attention(q, k, v, causal=cfg.causal,
                                  key_mask=key_mask)
        return self.o(out.reshape(B, T, -1))

    def forward_paged(self, x, cache, tables, pos, wblk, woff):
        """Fused paged decode/verify: scatter the fresh K/V into the
        SHARED flat block pool at the host-computed ``(wblk, woff)
        [N, tq]`` targets (in place — JAX donates and returns the
        pool), then the paged-attention kernel reads allocated,
        position-covered blocks through the block table.

        An int8 pool is written quantized (``_quantize_kv``: s8 values
        and their scale rows), so every read of these positions, this
        step's included, sees the stored bytes — which is what lets a
        re-prefill after preemption reproduce them.  A tp pool ``[tp,
        n_blocks, block, (KV/tp)*D]`` takes each shard's KV-head slice
        of the head-major row, and attention reads every shard in one
        launch (:func:`paged_attention_sharded`); the table and targets
        are the same on every shard."""
        B, T, _ = x.shape
        rpos = pos[:, None] + torch.arange(T, device=x.device)[None, :]
        q, k, v = self._qkv(x, rpos)
        pk, pv = cache["k"], cache["v"]
        tp = pk.shape[0] if pk.ndim == 4 else 1
        dst = (wblk, woff) if tp == 1 else (slice(None), wblk, woff)

        def rows(t):  # [B, T, W] -> the pool's [(tp,) B, T, W/tp]
            t = t.reshape(B, T, -1)
            return t if tp == 1 else t.reshape(B, T, tp, -1).permute(
                2, 0, 1, 3)

        scales = {}
        if pk.dtype == torch.int8:
            (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
            scales = {"k_scale": cache["k_scale"],
                      "v_scale": cache["v_scale"]}
            scales["k_scale"][dst] = rows(ks)
            scales["v_scale"][dst] = rows(vs)
        pk[dst] = rows(k).to(pk.dtype)
        pv[dst] = rows(v).to(pv.dtype)
        attend = paged_attention if tp == 1 else paged_attention_sharded
        out = attend(q, pk, pv, tables, pos, window=self.cfg.attn_window,
                     **scales)
        return self.o(out.reshape(B, T, -1))

    def forward_cached(self, x, row, pos, rpos, at,
                       fresh_prefill: bool = True):
        """Cached attention at the absolute offset ``pos``, whose query
        positions ``rpos [1|B, T]`` and cache write index ``at`` the caller
        built (``Transformer.decode``, once for every layer): the fresh K/V
        is written into ``row`` at ``[pos, pos+T)`` in place (quantized at
        write for an int8 cache), then attended, dispatched as the JAX
        ``Attention`` (``transformer.py:571-724``) on the cache's layout
        (``init_cache``): a flat ``[B, S, KV*D]`` cache decodes (T = 1)
        through the decode-attention kernel; a prompt at ``pos = 0``
        passing the gcd gate (``attn_impl="flash"``) takes the flash
        forward on the fresh K/V; other prompts at ``pos = 0`` on a flat
        or int8 cache attend the fresh, unquantized K/V densely; the rest
        is dense on the grouped ``[B, S, KV, D]`` view
        (``_cached_attention`` / ``_cached_attention_q8``).
        ``fresh_prefill=False`` drops the two ``pos = 0`` shortcuts, so a
        prompt attends the rows as any chunk does — the paged engine's
        chunks (JAX's traced position), whose int8 prompt must read the
        quantized values its later chunks and decode steps read.

        ``pos`` may be a ``[B]`` int32 tensor on the rows' device
        (``rpos`` then ``[B, T]``): row ``b`` runs at its own offset (the
        JAX ``decode`` under the dense engine's per-slot ``vmap``, whose
        position is traced): its rope
        angles, its K/V write at ``[pos[b], pos[b] + T)`` and its causal
        mask are its own, no value of ``pos`` is read on the host, and
        the two ``pos = 0`` shortcuts never apply.  ``at`` then may carry
        the fresh rows' source index of a span clamped at the row's end
        (``Transformer.decode``), so every write stays inside the row."""
        cfg = self.cfg
        if not cfg.causal:
            raise ValueError("KV-cache decode requires causal=True")
        B, T, _ = x.shape
        KV, D, w = cfg.kv_heads, cfg.d_head, cfg.attn_window
        per_row = isinstance(pos, torch.Tensor)
        q, k, v = self._qkv(x, rpos)
        ck, cv = row["k"], row["v"]
        S = ck.shape[1]
        if not per_row and pos + T > S:
            raise ValueError(f"cache write [{pos}, {pos + T}) overruns "
                             f"the {S}-row cache")
        quant = ck.dtype == torch.int8
        flat = ck.ndim == 3
        # ``at`` may carry a source index of the fresh rows (a span clamped
        # at the row's end, see ``Transformer.decode``)
        dst, src = at[:2], (at[2:] or None)

        def put(c, fresh):
            c[dst] = fresh if src is None else fresh[src]

        kw, vw = k, v
        if quant:
            (kw, ks), (vw, vs) = _quantize_kv(k), _quantize_kv(v)
            put(row["k_scale"], ks)
            put(row["v_scale"], vs)
        put(ck, kw.reshape(B, T, *ck.shape[2:]).to(ck.dtype))
        put(cv, vw.reshape(B, T, *cv.shape[2:]).to(cv.dtype))
        scales = (row["k_scale"], row["v_scale"]) if quant else (None, None)
        at_zero = not per_row and pos == 0 and fresh_prefill
        if (at_zero and T > 1 and cfg.attn_impl == "flash"
                and math.gcd(T, 1024) >= 128):
            # prefill: the valid keys are exactly the fresh k/v (an int8
            # cache's prompt attends them unquantized, as in JAX)
            out = flash_attention(q, k, v, causal=True, window=w)
        elif flat and T == 1:
            out = decode_attention(q, ck, cv, pos, k_scale=scales[0],
                                   v_scale=scales[1], window=w)
        elif at_zero and (flat or quant):
            out = _cached_attention(q, k, v, rpos, window=w)
        else:
            gk = ck.view(B, S, KV, D) if flat else ck
            gv = cv.view(B, S, KV, D) if flat else cv
            if quant:
                out = _cached_attention_q8(q, gk, scales[0], gv, scales[1],
                                           rpos, window=w)
            else:
                out = _cached_attention(q, gk, gv, rpos, window=w)
        return self.o(out.reshape(B, T, -1))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.kind = cfg.mlp
        if cfg.mlp == "swiglu":
            self.gate = _linear(cfg, cfg.d_model, cfg.d_ff, device,
                                param_dtype)
        elif cfg.mlp != "gelu":
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
        self.up = _linear(cfg, cfg.d_model, cfg.d_ff, device, param_dtype)
        self.down = _linear(cfg, cfg.d_ff, cfg.d_model, device, param_dtype)

    def forward(self, x):
        if self.kind == "swiglu":
            h = F.silu(self.gate(x)) * self.up(x)
        else:
            # flax nn.gelu defaults to the tanh approximation
            h = F.gelu(self.up(x), approximate="tanh")
        return self.down(h)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.ln1 = _make_norm(cfg, device)
        self.attn = Attention(cfg, device, param_dtype)
        self.ln2 = _make_norm(cfg, device)
        self.mlp = MLP(cfg, device, param_dtype)

    def _finish(self, x, attn_out):
        x = x + attn_out
        return x + self.mlp(self.ln2(x))

    def forward(self, x, key_mask=None):
        return self._finish(x, self.attn(self.ln1(x), key_mask))

    def forward_paged(self, x, cache, tables, pos, wblk, woff):
        return self._finish(x, self.attn.forward_paged(
            self.ln1(x), cache, tables, pos, wblk, woff))

    def forward_cached(self, x, row, pos, rpos, at,
                       fresh_prefill: bool = True):
        return self._finish(x, self.attn.forward_cached(
            self.ln1(x), row, pos, rpos, at, fresh_prefill))


class Transformer(nn.Module):
    """Causal LM.  ``forward(tokens [B, T])`` (training) and, over
    per-layer KV caches, ``decode`` / ``verify_tokens`` against dense
    rows, ``prefill_chunk_paged`` / ``decode_paged_fused`` and the gather
    fallback's ``decode_paged`` / ``verify_tokens_paged`` against the
    paged block pool.  Logits are ``[B, T, vocab]`` fp32.  ``param_dtype`` is
    the dtype the weights are kept in (fp32 for training; see the module
    docstring)."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        if cfg.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={cfg.attn_impl!r} needs the sequence-parallel "
                f"mesh, which belongs to the port's sequence-parallel "
                f"slice, not ported yet")
        if cfg.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                  device=device, dtype=param_dtype)
        if cfg.pos_emb == "learned":
            self.pos = nn.Embedding(cfg.max_seq_len, cfg.d_model,
                                    device=device, dtype=param_dtype)
        elif cfg.pos_emb not in ("rope", "none"):
            raise ValueError(f"unknown pos_emb {cfg.pos_emb!r}")
        self.blocks = nn.ModuleList(
            Block(cfg, device, param_dtype) for _ in range(cfg.num_layers))
        self.ln_f = _make_norm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = _linear(cfg, cfg.d_model, cfg.vocab_size,
                                   device, param_dtype, bias=False)
        self._head_f32 = None  # (weight key, fp32 copy); see logits

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def _embed(self, tokens, positions):
        # flax nn.Embed(dtype=...) casts the table, then looks up: the
        # same values, and the gradient reaches the fp32 table
        cdt = self.cfg.dtype
        x = self.embed(tokens).to(cdt)
        if self.cfg.pos_emb == "learned":
            x = x + self.pos(positions).to(cdt)
        return x

    def _head_weight_f32(self) -> torch.Tensor:
        """The head's weight rounded to the model dtype, in fp32.  Under
        autograd (training) it is computed from the parameter so the
        gradient reaches it — for a tied head, the embedding table.
        Otherwise (serving) a narrower copy is made once and kept (for
        Llama-3.2-1B's tied head, 1 GB that would otherwise be rewritten
        on every tick); the copy is remade when the weight is replaced,
        moved or written in place (an optimizer step,
        ``load_state_dict``)."""
        w = (self.embed.weight if self.cfg.tie_embeddings
             else self.lm_head.weight)
        cdt = self.cfg.dtype
        if torch.is_grad_enabled() and w.requires_grad:
            return w.to(cdt).to(torch.float32)
        if w.dtype == torch.float32 and cdt == torch.float32:
            return w.detach()
        key = (w.data_ptr(), w.device, w._version)
        if self._head_f32 is None or self._head_f32[0] != key:
            self._head_f32 = (key, w.detach().to(cdt).to(torch.float32))
        return self._head_f32[1]

    def head_weight(self) -> torch.Tensor:
        """The head's ``[vocab, d_model]`` weight cast to ``cfg.dtype``
        under autograd — the embedding table for a tied head,
        ``lm_head.weight`` otherwise — for the fused LM-head
        cross-entropy (the JAX ``_head_weight``, ``emb.T.astype(h.dtype)``,
        transposed back by the caller's ``.t()``).  The gradient reaches
        the parameter; no fp32 copy is made."""
        w = (self.embed.weight if self.cfg.tie_embeddings
             else self.lm_head.weight)
        if w.dtype == torch.int8:
            raise ValueError("the head is int8-quantized: the fused LM-head "
                             "cross-entropy trains float weights")
        return w.to(self.cfg.dtype)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """LM head: model-dtype operands, fp32 accumulation and output
        (the JAX head's ``preferred_element_type=float32``; a product of
        two model-dtype values is exact in fp32).  The tied variant
        multiplies by the input embedding table."""
        cdt = self.cfg.dtype
        if not self.cfg.tie_embeddings and self.lm_head.quantized:
            # the JAX QuantDense head: product in cdt, scaled in fp32
            return self.lm_head(h, out_dtype=torch.float32)
        return F.linear(h.to(cdt).to(torch.float32), self._head_weight_f32())

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """Everything up to and including the final norm: ``[B, T] ->
        [B, T, d_model]`` (no cache)."""
        T = tokens.shape[1]
        x = self._embed(tokens, torch.arange(T, device=tokens.device)[None])
        for block in self.blocks:
            x = block(x)
        return self.ln_f(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Training forward: ``tokens [B, T]`` -> fp32 logits ``[B, T,
        vocab]``."""
        return self.logits(self.hidden(tokens))

    def _head(self, x, last_only: bool, last_idx: Optional[int]):
        if last_only:
            x = x[:, -1:]
        elif last_idx is not None:
            x = x[:, last_idx:last_idx + 1]
        return self.logits(self.ln_f(x))

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, caches: Sequence[dict], pos,
               last_only: bool = False, last_idx: Optional[int] = None,
               fresh_prefill: bool = True):
        """One step over ``tokens [B, tq]`` at absolute offset ``pos``
        against per-layer caches from ``init_cache`` (flat or grouped, fp
        or int8), written in place at ``[pos, pos + tq)``.
        Returns ``(logits, caches)``.  Serves prefill (``pos=0``, the
        prompt) and decode (``tq=1``) alike; ``last_idx`` narrows the
        head to one chunk-local row (a right-padded chunk's true last
        token); ``fresh_prefill`` as in ``Attention.forward_cached``.
        ``pos`` a ``[B]`` int32 tensor runs every row at its own offset
        (the dense serving engine's decode tick over its slots; on a
        flat cache at ``tq = 1`` one decode-kernel launch a layer reads
        the vector itself).  The query positions and the cache write
        index are built here, once for every layer."""
        B, T = tokens.shape
        steps = torch.arange(T, device=tokens.device)
        if isinstance(pos, torch.Tensor):
            pos = pos.to(torch.int32)
            positions = pos.long()[:, None] + steps[None]       # [B, T]
            rows = torch.arange(B, device=tokens.device)[:, None]
            at = (rows, positions)
            S = caches[0]["k"].shape[1]
            if T > 1:
                # a span may run past its row's end (a verify at the last
                # positions, whose rows there are discarded): those writes
                # land on the row's last position with the value written
                # there, so every write stays in the row and no position
                # gets two different values
                src = torch.minimum(steps[None], (S - 1) - pos.long()[:, None])
                at = (rows, pos.long()[:, None] + src, rows, src)
            # and a learned position table's lookup stays in range
            x = self._embed(tokens,
                            positions.clamp(max=self.cfg.max_seq_len - 1))
        else:
            positions = (pos + steps)[None]                     # [1, T]
            at = (slice(None), slice(pos, pos + T))
            x = self._embed(tokens, positions)
        for block, c in zip(self.blocks, caches):
            x = block.forward_cached(x, c, pos, positions, at, fresh_prefill)
        return self._head(x, last_only, last_idx), caches

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, caches: Sequence[dict],
                      pos: int, last_idx: int) -> torch.Tensor:
        """Position-offset prefill (JAX ``Transformer.prefill_chunk``): the
        chunk ``tokens [B, C]`` written at ``[pos, pos + C)`` and attended
        against the rows, as at a traced position (no ``pos = 0``
        shortcut, so a first chunk attends the cache as every later one
        does); returns the ``[B, 1, vocab]`` logits at chunk-local
        ``last_idx`` (a right-padded final chunk's true last token)."""
        return self.decode(tokens, caches, pos, last_idx=last_idx,
                           fresh_prefill=False)[0]

    @torch.no_grad()
    def prefill_chunk_paged(self, tokens: torch.Tensor, pools: Sequence[dict],
                            table: torch.Tensor, pos: int, last_idx: int,
                            tp: int = 1):
        """Position-offset chunk prefill over the paged pool: gather the
        slot's rows through ``table [max_blocks]`` (up to the chunk's
        last block), run the dense chunk forward at ``[pos, pos + C)``,
        and scatter the chunk's fresh K/V back into the pool through
        the table (entries past the slot's grant are the null block, so
        pad positions land there).  Returns ``[1, 1, vocab]`` logits at
        chunk-local ``last_idx`` — the JAX engine's gather -> chunk ->
        scatter (``_paged_chunk_fn``), with the scatter done here.

        Every chunk, the first included, attends the gathered rows
        (``fresh_prefill=False``): over an int8 pool the chunk writes
        quantized rows and attends the s8 values and scales
        (``_cached_attention_q8``), the bytes decode reads.  A tp pool
        (``tp`` shards) is gathered into the unsharded row and scattered
        back per shard; a grouped pool (the gather fallback's fp pool at
        tp = 1) is gathered as it is."""
        _check_pool_tp(self.cfg, pools, tp)
        C = tokens.shape[1]
        bs = pools[0]["k"].shape[2 if tp > 1 else 1]
        nb = -(-(pos + C) // bs)
        rows = _regroup_tp_rows(self.cfg, gather_paged_rows(
            pools, table, hw_blocks=nb, tp=tp))
        logits, _ = self.decode(tokens, rows, pos, last_idx=last_idx,
                                fresh_prefill=False)
        p = torch.arange(pos, pos + C, device=table.device)
        scatter_paged_rows(pools, rows, p[None], table[p // bs][None],
                           (p % bs)[None], tp)
        return logits

    @torch.no_grad()
    def decode_paged_fused(self, tokens: torch.Tensor, pools: Sequence[dict],
                           tables: torch.Tensor, pos: torch.Tensor,
                           wblk: torch.Tensor, woff: torch.Tensor,
                           last_only: bool = False) -> torch.Tensor:
        """``decode`` against the paged pool WITHOUT a gather: every
        layer scatters the fresh K/V into the pool at ``(wblk, woff)
        [N, tq]`` and the paged-attention kernel reads the blocks in
        place through ``tables [N, max_blocks]``; ``pos [N]`` holds
        per-slot cursors.  Returns ``logits [N, tq|1, vocab]``; the
        pools (fp, int8 or tp, ``Attention.forward_paged``) are updated
        in place.  ``tq = 1`` is a decode step; ``tq = k + 1`` is the
        speculative verify (JAX ``verify_tokens_paged_fused``): the
        kernel treats every query row alike at any width."""
        T = tokens.shape[1]
        positions = pos[:, None] + torch.arange(T, device=pos.device)[None]
        # a verify span may run past the row's end, where its rows are
        # discarded: keep a learned table's lookup in range
        x = self._embed(tokens, positions.clamp(max=self.cfg.max_seq_len - 1))
        wb, wo = wblk.long(), woff.long()
        for block, c in zip(self.blocks, pools):
            x = block.forward_paged(x, c, tables, pos, wb, wo)
        return self._head(x, last_only, None)

    @torch.no_grad()
    def verify_tokens(self, tokens: torch.Tensor, caches: Sequence[dict],
                      pos):
        """Speculative verify (JAX ``verify_tokens``): ``decode`` at ``k +
        1`` query positions — ``tokens [B, k+1]``, the last emitted token
        and ``k`` proposals, written at ``[pos, pos + k + 1)`` — returning
        the logits at every position ``[B, k+1, vocab]`` and the caches.
        One attention implementation, so an accepted token's logits are
        the one-token decode's, and a rejected position's K/V lies past
        the caller's cursor, rewritten before the mask admits it.  ``pos``
        is an int or a ``[B]`` int32 tensor (the dense engine's verify,
        each slot at its cursor; a span running past its row's end is
        clamped there, ``decode``)."""
        return self.decode(tokens, caches, pos)

    @torch.no_grad()
    def decode_paged(self, tokens: torch.Tensor, pools: Sequence[dict],
                     tables: torch.Tensor, pos,
                     hw_blocks: Optional[int] = None, tp: int = 1,
                     last_only: bool = False):
        """``decode`` against the paged pool through a gather (JAX
        ``decode_paged``, the gather fallback): every slot's rows are
        gathered through ``tables [N, max_blocks]`` (or one slot's
        ``[max_blocks]``), capped at ``hw_blocks``, into ONE ``[N,
        hw_blocks * block, ...]`` row set — where JAX ``vmap``s a slot at a
        time — and the ordinary dense decode runs on it at ``pos`` (an int
        or an ``[N]`` int32 tensor).  Returns ``(logits, rows)``, the rows
        holding this step's K/V at ``[pos, pos + tq)`` for the caller's
        scatter (:func:`scatter_paged_rows`).

        The gather moves stored bytes, so the path is the dense cache's
        at any ``hw_blocks`` covering ``pos + tq``.  Routes, as JAX's: a
        grouped fp pool feeds ``_cached_attention``; a tp pool's flat rows
        are regrouped (:func:`_regroup_tp_rows`) onto that same branch; an
        int8 pool's flat rows decode on a CUDA device through the
        decode-attention kernel at the position vector (one launch a layer
        for every slot, tp pools too, so tp = 2 computes what tp = 1 does)
        and elsewhere through ``_cached_attention_q8``, the path JAX takes
        off its accelerator."""
        _check_pool_tp(self.cfg, pools, tp)
        rows = _grouped_rows(self.cfg, gather_paged_rows(
            pools, tables, hw_blocks=hw_blocks, tp=tp))
        logits, _ = self.decode(tokens, rows, pos, last_only=last_only)
        return logits, rows

    @torch.no_grad()
    def verify_tokens_paged(self, tokens: torch.Tensor, pools: Sequence[dict],
                            tables: torch.Tensor, pos,
                            hw_blocks: Optional[int] = None, tp: int = 1):
        """:meth:`verify_tokens` over the paged pool through a gather (JAX
        ``verify_tokens_paged``): :meth:`decode_paged` at ``k + 1`` query
        positions, returning ``(logits [N, k+1, vocab], rows)``."""
        return self.decode_paged(tokens, pools, tables, pos, hw_blocks, tp)


def _check_pool_tp(cfg: TransformerConfig, pools: Sequence[dict],
                   tp: int) -> None:
    """Refuse a ``tp`` that the pools' layout (``init_paged_cache``'s at
    that tp) does not carry, where the gather would read a shard axis as
    the block axis: ``tp > 1`` pools lead with ``tp`` shards of
    ``(KV/tp)*D``; ``tp = 1`` values are ``[n_blocks, block]`` rows of
    ``KV*D`` or ``(KV, D)``, scales ``[n_blocks, block, KV]``."""
    c = pools[0]
    KV, D = cfg.kv_heads, cfg.d_head
    k = c["k"]
    if tp > 1:
        ok = (all(t.ndim == 4 and t.shape[0] == tp for t in c.values())
              and k.shape[-1] * tp == KV * D)
    else:
        ok = (tuple(k.shape[2:]) in ((KV * D,), (KV, D))
              and all(t.ndim == 3 for n, t in c.items() if n != "k"
                      and n != "v"))
    if not ok:
        raise ValueError(f"paged pools of shape {tuple(k.shape)} are not "
                         f"a tp={tp} pool")


def _regroup_tp_rows(cfg: TransformerConfig, rows: Sequence[dict]):
    """Flat k/v rows ``[B, S, KV*D]`` viewed grouped ``[B, S, KV, D]``
    (scale leaves stay ``[B, S, KV]``), the JAX ``_regroup_tp_rows``: the
    flat minor axis is head-major, so the view is byte-identical to a
    grouped gather, and it routes the tp gather onto the grouped dense
    branch an unsharded grouped engine runs."""
    KV, D = cfg.kv_heads, cfg.d_head
    return [{n: (r[n].view(*r[n].shape[:2], KV, D) if n in ("k", "v")
                 else r[n]) for n in r} for r in rows]


def _grouped_rows(cfg: TransformerConfig, rows: List[dict]) -> List[dict]:
    """The gathered rows as :meth:`Transformer.decode_paged` attends them:
    flat fp rows (a tp pool's) regrouped, as JAX does; flat int8 rows
    regrouped except on a CUDA device, where the decode kernel reads them
    flat (JAX regroups an int8 tp pool's rows too, and its tp = 1 rows
    reach its decode kernel only on its accelerator: off it, both attend
    through ``_cached_attention_q8``, as the regrouped rows do here)."""
    k = rows[0]["k"]
    if k.ndim == 4 or (k.dtype == torch.int8 and k.is_cuda):
        return rows
    return _regroup_tp_rows(cfg, rows)


def gather_paged_rows(pools: Sequence[dict], tables: torch.Tensor,
                      hw_blocks: Optional[int] = None,
                      tp: int = 1) -> List[dict]:
    """Contiguous rows of per-layer pools through block tables: ``tables
    [N, max_blocks]`` (or one slot's ``[max_blocks]``, ``N = 1``) ->
    ``[N, hw_blocks * block, ...]`` (a copy; ``hw_blocks`` caps the
    gather at the slots' high-water block).  Flat ``[n_blocks, block,
    X]`` and grouped ``[n_blocks, block, KV, D]`` pools keep their
    layout; per-shard pools ``[tp, n_blocks, block, X]`` (``tp > 1``)
    give the unsharded flat row ``[N, S, tp * X]``: the shards' minor
    axes side by side, which is the head-major row, byte for byte.
    Positions past a slot's cursor gather whatever the blocks hold (the
    null block's, or a stale block's), which the causal mask never
    admits."""
    idx = tables.long().reshape(-1, tables.shape[-1])
    if hw_blocks is not None:
        idx = idx[:, :hw_blocks]
    N, nb = idx.shape
    flat = idx.reshape(-1)
    out = []
    for layer in pools:
        row = {}
        for name, c in layer.items():
            if tp > 1:
                # (contiguous: with one KV head a shard, the scale rows'
                # reshape would be a strided view)
                g = c.index_select(1, flat)      # [tp, N * nb, block, X]
                g = g.view(tp, N, -1, g.shape[-1]).permute(1, 2, 0, 3)
                row[name] = g.reshape(N, -1, tp * g.shape[-1]).contiguous()
            else:
                g = c.index_select(0, flat)      # [N * nb, block, ...]
                row[name] = g.view((N, -1) + tuple(g.shape[2:]))
        out.append(row)
    return out


def scatter_paged_rows(pools: Sequence[dict], rows: Sequence[dict],
                       positions: torch.Tensor, wblk: torch.Tensor,
                       woff: torch.Tensor, tp: int = 1) -> None:
    """Write the gathered ``rows``' values at ``positions [N, t]`` back
    into the pools at ``(wblk, woff) [N, t]``, in place: the written span
    of a gather step (the JAX engine's scatter after ``decode_paged``).
    A position past a row's end (a verify span at the row's last
    positions, aimed at the null block) reads the row's last position.
    A tp pool takes each shard's head-major slice."""
    S = rows[0]["k"].shape[1]
    at = (torch.arange(positions.shape[0], device=positions.device)[:, None],
          positions.long().clamp(max=S - 1))
    wb, wo = wblk.long(), woff.long()
    for pool, row in zip(pools, rows):
        for n, c in pool.items():
            fresh = row[n][at]                       # [N, t, ...]
            if tp == 1:
                c[wb, wo] = fresh.reshape(wb.shape + c.shape[2:])
            else:
                c[:, wb, wo] = fresh.reshape(*fresh.shape[:2], tp, -1) \
                    .permute(2, 0, 1, 3)


def init_cache(cfg: TransformerConfig, batch_size: int, max_len: int,
               quantized: bool = False, layout: str = "auto",
               device=None) -> List[dict]:
    """Zeroed per-layer KV caches for ``Transformer.decode`` (the JAX
    ``init_cache``), on ``device``:

    * ``layout="flat"`` — ``{"k","v"} [B, max_len, KV*D]``, the layout
      the decode-attention kernel reads;
    * ``"grouped"`` — ``[B, max_len, KV, D]``, the dense path's;
    * ``"auto"`` — flat on a CUDA device for a causal model when
      ``decode_attention_usable`` passes (an int8 cache under MHA only, as
      JAX chooses on its accelerator), grouped otherwise (and on the CPU).

    ``quantized=True`` stores int8 values plus fp32 per-(position, head)
    scales ``"k_scale"/"v_scale" [B, max_len, KV]``; K/V are quantized as
    they are written.  Unwritten rows are masked, so zeros never reach
    the softmax."""
    if max_len > cfg.max_seq_len:
        raise ValueError(
            f"cache max_len {max_len} exceeds max_seq_len {cfg.max_seq_len}")
    if layout not in CACHE_LAYOUTS:
        raise ValueError(f"unknown cache layout {layout!r}")
    KV, D = cfg.kv_heads, cfg.d_head
    if layout == "auto":
        on_cuda = device is not None and torch.device(device).type == "cuda"
        use_flat = (cfg.causal and on_cuda and decode_attention_usable(
            (batch_size, 1, cfg.num_heads, D), max_len, quantized,
            kv_heads=KV))
        layout = "flat" if use_flat else "grouped"
    shape = ((batch_size, max_len, KV * D) if layout == "flat"
             else (batch_size, max_len, KV, D))

    def layer():
        if not quantized:
            return {n: torch.zeros(shape, dtype=cfg.dtype, device=device)
                    for n in ("k", "v")}
        out = {n: torch.zeros(shape, dtype=torch.int8, device=device)
               for n in ("k", "v")}
        for n in ("k_scale", "v_scale"):
            out[n] = torch.zeros((batch_size, max_len, KV),
                                 dtype=torch.float32, device=device)
        return out

    return [layer() for _ in range(cfg.num_layers)]


@torch.no_grad()
def init_weights(model: nn.Module, seed: int, std: float = 0.02) -> None:
    """Random weights from ``seed`` on the model's own device: normal
    ``std`` for matrices and embeddings, ones for norm scales, zeros
    for biases.  The same seed gives the same weights on a device.  Any
    module of the port's layers takes it (a ``Transformer``, the BERT
    models)."""
    g = torch.Generator(device=next(model.parameters()).device)
    g.manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=g)
