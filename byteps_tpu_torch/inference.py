"""Cached generation — the port of ``byteps_tpu/inference.py``:
``make_generate_fn`` / ``generate`` (``:231``, ``:443``) over the flat or
grouped, fp or int8 KV caches of ``models.transformer.init_cache``;
``beam_search`` (``:466``); ``speculative_generate`` (``:605``) with
``truncated_draft`` (``:578``), the LayerSkip self-draft that
``lm_loss_fn(early_exit=...)`` trains; ``quantize_params`` (``:136``),
the int8 weight-only model; ``classify_divergence`` (``:39``); and
``sample_logits`` (``:192``, temperature, top-k, top-p) with the port's
own sampling-noise chain.

Generation runs where the model's weights live (``Transformer(cfg,
device=...)``): prefill is one ``Transformer.decode`` over the prompt at
``pos = 0`` (the flash forward under ``attn_impl="flash"``), then one
``decode`` per token (on a flat cache the decode-attention kernel; with
``quantize_params`` every projection through the int8 product kernel).
PyTorch runs the loop eagerly, so the JAX ``lax.scan`` and
``_layout_aware_jit`` / ``_AutoLayoutCache`` (XLA entry-layout
machinery for int8 trees) have no counterpart.

JAX draws from ``jax.random`` keys; PyTorch's generators give other
numbers from the same seed, so sampled streams of the two packages
differ while greedy streams agree token for token.  The port's chain is
a pure function of ``(seed, k)``: the ``k``-th token of a request with
seed ``seed`` is drawn with Gumbel noise from a CPU ``torch.Generator``
seeded from ``(seed, k)`` (:func:`token_generator`).  So a request's
sampled stream does not depend on batch composition, on the device, or
on preemption and resume — resuming after ``k`` tokens needs only ``k``.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .models.transformer import Dense, Transformer, init_cache

__all__ = ["make_generate_fn", "generate", "beam_search", "sample_logits",
           "quantize_params", "classify_divergence", "token_generator",
           "truncated_draft", "speculative_generate"]


def token_generator(seed: int, k: int) -> torch.Generator:
    """CPU generator for the ``k``-th emitted token of a request seeded
    ``seed`` (a hash of the pair, so nearby seeds do not overlap)."""
    h = hashlib.blake2b(f"{int(seed)}:{int(k)}".encode(), digest_size=8)
    g = torch.Generator(device="cpu")
    g.manual_seed(int.from_bytes(h.digest(), "little") >> 1)
    return g


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Sample token ids from ``logits [B, vocab]``.

    ``temperature == 0`` is greedy argmax (first index on ties, as
    ``jnp.argmax``).  ``top_k`` keeps the k highest logits; ``top_p``
    keeps the smallest prefix of the sorted distribution with
    cumulative probability >= top_p (the highest-probability token is
    always kept); k first, then p, with the JAX version's tie rule
    (mask by value threshold).  Sampling is Gumbel-max with noise drawn
    on the CPU from ``generator`` and moved to the logits' device, so a
    generator state gives the same token on every device."""
    if temperature == 0:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    V = logits.shape[-1]
    if top_k is not None and top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose exclusive cumulative mass is < top_p
        keep_sorted = (cum - probs) < top_p
        kept = sorted_logits.masked_fill(~keep_sorted, float("inf"))
        threshold = kept.min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u)).to(logits.device)
    return torch.argmax(logits + gumbel, dim=-1)


def truncated_draft(model: Transformer, num_layers: int) -> Transformer:
    """LayerSkip-style self-draft: a ``Transformer`` whose config has
    ``num_layers`` and whose embeddings, first ``num_layers`` blocks,
    final norm and head are the target's own modules — the same
    ``nn.Parameter`` objects, so nothing is copied and a gradient through
    the draft reaches the target's weights (the JAX version returns the
    same arrays in a filtered tree)."""
    cfg = model.cfg
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(
            f"draft num_layers {num_layers} not in [1, {cfg.num_layers}]")
    # built on the meta device (no memory), then given the target's modules
    draft = Transformer(dataclasses.replace(cfg, num_layers=num_layers),
                        device="meta")
    draft.embed = model.embed
    if cfg.pos_emb == "learned":
        draft.pos = model.pos
    draft.blocks = nn.ModuleList(model.blocks[:num_layers])
    draft.ln_f = model.ln_f
    if not cfg.tie_embeddings:
        draft.lm_head = model.lm_head
    return draft


def quantize_params(model: Transformer, inplace: bool = True) -> Transformer:
    """Int8 weight-only quantization of every projection (``Dense``: q, k,
    v, o, the MLP, an untied head): symmetric per-output-channel int8
    weights plus fp32 scales, absmax over the contraction dims / 127 —
    the JAX ``quantize_params``, bit for bit on the same float weights.
    Embeddings and norms are untouched.  The forward then runs the int8
    product kernel (``ops/quant_dot.py``) with ``QuantDense``'s rounding.
    ``inplace=False`` quantizes a deep copy and leaves ``model`` as is."""
    if not inplace:
        model = copy.deepcopy(model)
    for m in model.modules():
        if isinstance(m, Dense):
            m.quantize()
    return model


def _sampling_generator(temperature: float, seed: Optional[int], k: int):
    return None if temperature == 0 else token_generator(seed, k)


def make_generate_fn(model: Transformer, max_new_tokens: int, *,
                     temperature: float = 1.0, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     eos_id: Optional[int] = None, pad_id: int = 0,
                     kv_quant: bool = False, cache_len: Optional[int] = None,
                     cache_layout: str = "auto"):
    """``fn(prompt [B, T], seed=None, on_step=None) -> {"tokens": [B,
    max_new_tokens], "done": [B]}``: appends ``max_new_tokens`` sampled
    tokens to each fully valid prompt row, on the model's device.

    As the JAX ``make_generate_fn``: rows that emit ``eos_id`` are frozen
    to ``pad_id`` for the remaining steps; ``kv_quant`` decodes against an
    int8 KV cache; ``cache_len`` over-allocates the cache beyond ``T +
    max_new_tokens`` (smaller raises); ``cache_layout`` forwards to
    ``init_cache`` (``"auto"``: flat on a CUDA device where the kernel's
    gate passes, else grouped); prefill applies the head to the last
    position only.  ``temperature > 0`` draws the ``k``-th token from
    :func:`token_generator` ``(seed, k)`` and needs a ``seed``.
    ``on_step(i)``, if given, is called after the prefill (``i = 0``) and
    after each decode step (``i`` = tokens so far), for timing."""
    cfg = model.cfg
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")

    @torch.no_grad()
    def run(prompt, seed: Optional[int] = None,
            on_step: Optional[Callable[[int], None]] = None):
        if temperature != 0 and seed is None:
            raise ValueError("temperature > 0 samples stochastically: pass "
                             "seed= (each seed gives a distinct sample)")
        dev = model.device
        prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(
            prompt) else prompt).to(dev, torch.long)
        B, T = prompt.shape
        need = T + max_new_tokens
        if cache_len is not None and cache_len < need:
            raise ValueError(f"cache_len={cache_len} < prompt + "
                             f"max_new_tokens ({need})")
        caches = init_cache(cfg, B, cache_len or need, quantized=kv_quant,
                            layout=cache_layout, device=dev)
        logits, _ = model.decode(prompt, caches, 0, last_only=True)
        tok = sample_logits(logits[:, -1],
                            _sampling_generator(temperature, seed, 0),
                            temperature, top_k, top_p)
        done = (tok == eos_id if eos_id is not None
                else torch.zeros(B, dtype=torch.bool, device=dev))
        toks = [tok]
        if on_step is not None:
            on_step(0)
        for i in range(max_new_tokens - 1):
            logits, _ = model.decode(tok[:, None], caches, T + i)
            nxt = sample_logits(logits[:, -1],
                                _sampling_generator(temperature, seed, i + 1),
                                temperature, top_k, top_p)
            nxt = nxt.masked_fill(done, pad_id)
            if eos_id is not None:
                done = done | (nxt == eos_id)
            tok = nxt
            toks.append(tok)
            if on_step is not None:
                on_step(i + 1)
        return {"tokens": torch.stack(toks, dim=1), "done": done}

    return run


def generate(model: Transformer, prompt, max_new_tokens: int, *,
             temperature: float = 1.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, eos_id: Optional[int] = None,
             pad_id: int = 0, seed: Optional[int] = None,
             kv_quant: bool = False, cache_len: Optional[int] = None,
             cache_layout: str = "auto") -> dict:
    """One call of :func:`make_generate_fn`.  Sampling (``temperature >
    0``) requires a ``seed`` — a silent default would return the same
    "sample" every call; greedy (``temperature=0``) needs none."""
    fn = make_generate_fn(model, max_new_tokens, temperature=temperature,
                          top_k=top_k, top_p=top_p, eos_id=eos_id,
                          pad_id=pad_id, kv_quant=kv_quant,
                          cache_len=cache_len, cache_layout=cache_layout)
    return fn(prompt, seed)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, ties to the lower index (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(model: Transformer, prompt, max_new_tokens: int,
                num_beams: int, *, length_penalty: float = 1.0,
                eos_id: Optional[int] = None, pad_id: int = 0,
                cache_len: Optional[int] = None) -> dict:
    """Beam search with the KV cache (the JAX ``beam_search``): every live
    beam expands over the vocabulary and the ``num_beams`` best cumulative
    log-probabilities of each batch row survive.  The prefill runs once
    on the ``[B, T]`` prompt (the flash forward under ``attn_impl="flash"``
    at a prompt passing its gate), its ``K`` best first tokens seed the
    beams, and the caches (``init_cache``'s default layout: flat on a CUDA
    device, so every step is one decode-kernel launch a layer over the
    ``B * K`` rows) are tiled beam-major to ``[B * K, ...]``; each step
    reorders every cache leaf (int8 scales included) to the surviving
    parents with ``index_select``.  EOS is frozen-slot: a beam that emits
    ``eos_id`` keeps its slot, emitting ``pad_id`` at no cost and a frozen
    length.  Beams are ranked by ``score / length ** length_penalty``.

    Returns ``{"tokens": [B, N], "scores": [B], "beam_tokens": [B, K,
    N], "beam_scores": [B, K]}`` — tokens and scores are the best beam's.
    ``cache_len`` over-allocates the cache (smaller than ``T + N``
    raises)."""
    cfg = model.cfg
    K, V, N = num_beams, cfg.vocab_size, max_new_tokens
    dev = model.device
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(
        prompt) else prompt).to(dev, torch.long)
    B, T = prompt.shape
    if cache_len is not None and cache_len < T + N:
        raise ValueError(f"cache_len={cache_len} < prompt + max_new_tokens "
                         f"({T + N})")
    caches = init_cache(cfg, B, cache_len or (T + N), device=dev)
    logits, _ = model.decode(prompt, caches, 0, last_only=True)
    scores, tok0 = _top_k(torch.log_softmax(logits[:, -1].float(), -1), K)
    caches = [{n: c.repeat_interleave(K, dim=0) for n, c in layer.items()}
              for layer in caches]
    tok = tok0.reshape(B * K)
    done = (tok == eos_id if eos_id is not None
            else torch.zeros(B * K, dtype=torch.bool, device=dev))
    lengths = torch.ones(B * K, dtype=torch.int32, device=dev)
    history = torch.full((B * K, N), pad_id, dtype=torch.long, device=dev)
    history[:, 0] = tok
    scores = scores.reshape(B * K)
    # finished beams: only pad continues, at zero cost
    pad_row = torch.full((V,), -1e30, device=dev)
    pad_row[pad_id] = 0.0
    base = torch.arange(B, device=dev)[:, None] * K
    for i in range(N - 1):
        logits, _ = model.decode(tok[:, None], caches, T + i)
        lp = torch.log_softmax(logits[:, -1].float(), -1)       # [B*K, V]
        lp = torch.where(done[:, None], pad_row[None], lp)
        cand = (scores[:, None] + lp).reshape(B, K * V)
        new_scores, idx = _top_k(cand, K)                       # [B, K]
        parent = (base + idx // V).reshape(-1)
        caches = [{n: c.index_select(0, parent) for n, c in layer.items()}
                  for layer in caches]
        done, lengths = done[parent], lengths[parent]
        history = history[parent]
        tok = torch.where(done, pad_id, (idx % V).reshape(-1))
        history[:, i + 1] = tok
        lengths = torch.where(done, lengths, lengths + 1)
        if eos_id is not None:
            done = done | (tok == eos_id)
        scores = new_scores.reshape(-1)
    norm = (scores / lengths.float() ** length_penalty).reshape(B, K)
    best = torch.argmax(norm, dim=-1)
    history = history.reshape(B, K, N)
    rows = torch.arange(B, device=dev)
    return {"tokens": history[rows, best], "scores": norm[rows, best],
            "beam_tokens": history, "beam_scores": norm}


@torch.no_grad()
def speculative_generate(target: Transformer, draft: Transformer, prompt,
                         max_new_tokens: int, *, gamma: int = 4,
                         eos_id: Optional[int] = None, pad_id: int = 0,
                         cache_len: Optional[int] = None) -> dict:
    """Greedy speculative decoding (the JAX ``speculative_generate``): the
    draft proposes ``gamma`` tokens one at a time, the target verifies
    them in ONE ``gamma + 1``-token ``verify_tokens`` call, and the
    longest agreeing prefix is accepted plus the target's own next token,
    so each target forward emits 1 to ``gamma + 1`` tokens; the output is
    the target's own greedy decode but for near-tie argmax flips between
    the verify's and a one-token step's sums.  The target cache is grouped
    (every target call but the prefill is a ``tq > 1`` verify); the draft
    cache is ``init_cache``'s default (flat on a CUDA device: every draft
    step one decode-kernel launch a layer).  Acceptance is lockstep at the
    batch's shortest accepted prefix (one scalar position for every row),
    rows that emitted ``eos_id`` emit ``pad_id`` after it, within a round
    too; rejected K/V lies past the position and is overwritten later.
    The draft is any model over the same vocabulary, e.g.
    :func:`truncated_draft` of the target.

    Returns ``{"tokens": [B, N], "acceptance": accepted drafts over live
    drafted slots, "rounds": target verify calls,
    "tokens_per_target_forward": N / rounds}``."""
    N, G = max_new_tokens, gamma
    dev = target.device
    prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(
        prompt) else prompt).to(dev, torch.long)
    B, T = prompt.shape
    need = T + N + G + 1
    if cache_len is not None and cache_len < need:
        raise ValueError(f"cache_len={cache_len} < prompt + max_new_tokens "
                         f"+ gamma + 1 ({need})")
    S = cache_len or need
    t_caches = init_cache(target.cfg, B, S, layout="grouped", device=dev)
    d_caches = init_cache(draft.cfg, B, S, device=dev)
    t_logits, _ = target.decode(prompt, t_caches, 0, last_only=True)
    draft.decode(prompt, d_caches, 0, last_only=True)
    last = torch.argmax(t_logits[:, -1], dim=-1)         # pending token
    out = torch.full((B, N + G + 1), pad_id, dtype=torch.long, device=dev)
    out[:, 0] = last
    done = (last == eos_id if eos_id is not None
            else torch.zeros(B, dtype=torch.bool, device=dev))
    cols = torch.arange(G + 1, device=dev)[None]
    emitted, rounds, acc, live_slots = 1, 0, 0, 0
    while emitted < N:
        pos = T + emitted - 1     # both caches' valid length
        drafts, tok = [], last
        for j in range(G):
            lg, _ = draft.decode(tok[:, None], d_caches, pos + j)
            tok = torch.argmax(lg[:, -1], dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)               # [B, G]
        t_lg, _ = target.verify_tokens(
            torch.cat([last[:, None], drafts], dim=1), t_caches, pos)
        t_arg = torch.argmax(t_lg, dim=-1)                # [B, G+1]
        k = torch.cumprod((t_arg[:, :G] == drafts).int(), dim=1).sum(1)
        kmin = int(torch.where(done, G, k).min())
        take = kmin + 1
        corr = t_arg[:, kmin]
        toks = torch.where(cols < kmin, torch.cat(
            [drafts, drafts[:, :1]], dim=1), pad_id)
        toks[:, kmin] = corr
        toks = torch.where(cols >= take, pad_id, toks)
        done_new = done
        if eos_id is not None:
            # positions after a row's first EOS become pad
            is_eos = (toks == eos_id) & (cols < take)
            after = (torch.cumsum(is_eos.int(), dim=1) - is_eos.int()) > 0
            toks = torch.where(after, pad_id, toks)
            done_new = done | is_eos.any(dim=1)
        toks = torch.where(done[:, None], pad_id, toks)
        out[:, emitted:emitted + G + 1] = toks
        last = torch.where(done, last, corr)
        n_live = int((~done).sum())
        done = done_new
        emitted += take
        rounds += 1
        acc += kmin * n_live
        live_slots += G * n_live
    return {"tokens": out[:, :N], "acceptance": acc / max(live_slots, 1),
            "rounds": rounds, "tokens_per_target_forward": N / max(rounds, 1)}


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@torch.no_grad()
def classify_divergence(model: Transformer, prompt, tokens_a, tokens_b, *,
                        tie_rtol: float = 0.02, tie_atol: float = 0.05):
    """Diagnose the first disagreement between two greedy decodes of the
    same model (the JAX ``classify_divergence``): path A's tokens are
    teacher-forced through one full forward, and at each row's first
    divergent position ``d`` the logits of the two chosen tokens are
    compared — within ``tie_rtol * max|logit| + tie_atol`` is ``"tie"``
    (a near-tie argmax flipped by rounding), beyond it ``"real"`` (path B
    chose a token the model scores clearly lower); identical decodes are
    ``"none"``.  Returns the worst row's verdict with ``agreement``,
    ``first_div_pos``, ``delta_logit``, ``tie_threshold``, and the position
    profile ``first_div_positions`` / ``div_frac_by_quarter``."""
    toks_a, toks_b = _numpy(tokens_a), _numpy(tokens_b)
    assert toks_a.shape == toks_b.shape
    B, N = toks_a.shape
    agree = float((toks_a == toks_b).mean())
    if (toks_a == toks_b).all():
        return {"divergence": "none", "agreement": 1.0,
                "first_div_pos": -1, "delta_logit": 0.0,
                "tie_threshold": 0.0, "first_div_positions": [-1] * B,
                "div_frac_by_quarter": ([0.0] * 4 if N >= 4 else [])}
    neq = toks_a != toks_b
    first_divs = [int(np.nonzero(neq[b])[0][0]) if neq[b].any() else -1
                  for b in range(B)]
    quarters = [round(float(neq[:, i * N // 4:(i + 1) * N // 4].mean()), 4)
                for i in range(4)] if N >= 4 else []
    prompt = _numpy(prompt)
    T = prompt.shape[1]
    full_a = torch.from_numpy(np.concatenate([prompt, toks_a], axis=1)).to(
        model.device, torch.long)
    # the head at the rows that produced each first divergent token only
    # (the full [B, T + N, vocab] logits are the same there)
    h = model.hidden(full_a)
    worst = {"divergence": "none", "agreement": agree,
             "first_div_pos": -1, "delta_logit": 0.0, "tie_threshold": 0.0,
             "first_div_positions": first_divs,
             "div_frac_by_quarter": quarters}
    rank = {"none": 0, "tie": 1, "real": 2}
    for b in range(B):
        d = first_divs[b]
        if d < 0:
            continue
        # logits that produced generated token d live at sequence
        # position T + d - 1 (the previous token's output)
        row = model.logits(h[b:b + 1, T + d - 1])[0].float().cpu().numpy()
        la, lb = float(row[toks_a[b, d]]), float(row[toks_b[b, d]])
        thr = tie_rtol * float(np.abs(row).max()) + tie_atol
        kind = "tie" if abs(la - lb) <= thr else "real"
        if rank[kind] > rank[worst["divergence"]] or (
                kind == worst["divergence"]
                and abs(la - lb) > abs(worst["delta_logit"])):
            worst = {"divergence": kind, "agreement": agree,
                     "first_div_pos": d, "delta_logit": round(la - lb, 4),
                     "tie_threshold": round(thr, 4),
                     "first_div_positions": first_divs,
                     "div_frac_by_quarter": quarters}
    return worst
