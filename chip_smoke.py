#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``byteps_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises (non-zero exit, no result line) on failure:

1. Device — the ``nvidia-smi`` name / power-limit line, torch and CUDA
   versions.  Exits 1 at once when ``torch.cuda.is_available()`` is
   false.
2. Build — compiles every kernel of the serving and training paths from
   the sources in the checkout (one ``nvcc`` per source, ``sm_90a``,
   started together) and prints the build seconds and ``ptxas``'s
   register and spill lines; then the paged kernel's and the bf16 flash
   kernels' on tensor cores (forward, dq, dk/dv) per instantiation, and
   fails if any of the three spills at head_dim 64 or 128.
3. Reference — a small fp32 Llama-shaped model served greedily through
   the paged engine (the kernel decoding) must give exactly the tokens
   of a plain dense-cache greedy loop (``Transformer.decode``, no
   kernel); seeded sampled streams (temperature 0.8, top-k 50, top-p
   0.95) of two fresh engines must repeat token for token.
4. Serve (the main path) — Llama-3.2-1B at full width (16 layers,
   d_model 2048, 32 heads over 8 KV heads, head_dim 64, d_ff 8192, vocab
   128256, rope theta 500000 with llama3 scaling, tied embeddings;
   ``meta-llama/Llama-3.2-1B`` ``config.json``) in bf16 with random
   weights from ``--seed``; max_seq cut from 131072 to 2048.  A
   ``ServeFrontend`` on localhost serves 8 concurrent greedy requests
   (prompts of 32-512 tokens, 32 new tokens each) to
   ``RemoteServeClient``s, twice: both runs must complete at the right
   lengths with identical tokens, every paged-attention launch of the
   run must be one per layer per decode tick, and nothing may run on
   the CPU.  The kernel counts are set to 0 just before each run and
   read just after.
5. Kernel — the paged-attention kernel against its plain PyTorch version
   on the card at Llama-3.2-1B shapes (H=32, KV=8, D=64, block 16, B=8):
   ragged cursors 1..2047 over null-padded tables, all slots at 2047,
   tq=1 and tq=5 (speculation at k=4), window 256, fp32 and bf16, in the
   fp mode and the int8 mode (s8 pools with fp32 scale pools, the scale
   rows past each cursor garbage; q fp32 or bf16), plus the cursors of
   the serve run's last decode tick.  Max abs error <= 1e-4 in fp32
   (online vs dense softmax order) and <= 2e-2 in bf16 (p is rounded to
   bf16 before the PV product, so one bf16 ulp of a probability reaches
   the output); the int8 mode with a bf16 q within 2 bf16 ulps of each
   output row's largest reference magnitude (both sides round p and the
   output at the same points).  Every int8 case also runs the tp wrapper
   at tp=2 and 4 on the same bytes cut into per-shard pools: the output
   bit-identical to the unsharded launch (printed;
   held to the same tolerance).  One launch at every tp (the shard is a
   grid coordinate).  Times (fp cases, and the int8 mode with a bf16 q): device
   time per call from CUDA graphs of 20 (flush, call) pairs less the
   flushes, as in phase 16, of the kernel (and the tp=2 wrapper) and of
   ``F.scaled_dot_product_attention(enable_gqa=True)`` over pre-gathered
   dense rows (dequantized to bf16 for int8) as a yardstick (never called
   by the port); the plain version by CUDA events around each call (it
   syncs to size its gather, so it cannot be captured); the bound is the
   bytes the kernel must move (values, and int8 scales) over 3.35 TB/s
   (or its FLOPs over the dtype's peak if larger).  One more case per
   mode and dtype at head_dim 32 (4 heads, MHA: the serve role's default
   model).
6. Serve role — ``serve_from_env`` with only ``BYTEPS_SERVE_PAGED=1``:
   the default model (d_model 128, 4 heads, head_dim 32) on the GPU
   answers two identical greedy requests identically, through the
   kernel (one launch per layer per tick); then again with
   ``BYTEPS_SERVE_KV_DTYPE=int8 BYTEPS_TP=2 BYTEPS_SERVE_PREFIX_CACHE=1
   BYTEPS_SERVE_SPEC=1``: the pool sharded in two and int8, the second
   request a prefix hit, every tick a verify pass, one launch per layer
   per tick (the tp wrapper launches once for both shards).
6b. Tiers reference — the phase-3 fp32 model: the int8-pool engine (the
   kernel's int8 mode) gives exactly the greedy tokens of a plain dense
   loop over an int8 grouped cache whose prompt is quantized at write
   and attended as int8 (``Transformer.decode(fresh_prefill=False)``, no
   kernel; whether ``inference.generate(kv_quant=True)``, which attends
   its prompt unquantized, agrees is printed); tp=2 gives tp=1's tokens
   for fp and int8 pools; the prefix cache on gives the tokens of off
   (int8, prompts sharing 64 tokens, >= 3 hits); speculation (k=4) on
   gives the tokens of off, greedy (fp and int8) and seeded.
6c. Tiers serve (the main path of the tiers slice) — phase 4's
   Llama-3.2-1B in bf16 behind a ``ServeFrontend``: an int8 pool at 513
   MiB (phase 4's 1025-block bf16 pool, 537.4 MB, in whole MiB), the prefix
   cache, speculation at k=4, tp=1.  One warm request, then 8 concurrent
   ones; a base prompt is a shared 256-token prefix, 64-256 unique tokens
   and an 8-token run repeated twice (336-528 tokens); 32 new tokens
   each.  Run with the n-gram proposer at tp=1, then tp=2 (random
   weights accept none of its proposals: the answer changes with any
   change of its context, so no copy of it can sit in a prompt), then on
   fresh engines at tp=1 and tp=2 with a replay proposer offering each
   request's answer from the first run: the accept path at full width
   (cursors moving up to 5, the accepted rows quantized at scatter, tp=2
   writes at tq=5), which must accept.  All four runs token-identical.
   Each run: >= 8 prefix hits, every tick a verify pass, exactly one
   kernel launch per layer per tick (at tp=2 too), no plain version
   called; TTFT/TPOT p50/p99, tokens/s, the acceptance rate, and the blocks the
   budget holds in int8 against bf16.  Then the int8 mode and the tp=2
   wrapper at the last tick's cursors, timed as in phase 5.
7. Training reference — a small fp32 Llama-shaped model (2 layers,
   d_model 256, 4 heads over 2 KV heads, head_dim 64, vocab 1024), B=2,
   T=256: 3 ``Trainer.fit`` steps with ``attn_impl="flash"`` (the
   kernels) and 3 from the same weights with ``"local"`` (no kernel),
   SGD momentum 0.9.  Losses agree within 1e-5 relative; step-1
   gradients within 1e-4 of each tensor's largest entry (fp32 sums in
   other orders; Adam is not used here, as its m / sqrt(v) would turn
   that rounding into updates of up to lr).
8. Train (the main path of the training slice) — Llama-3.2-1B at full
   width, bf16 compute on fp32 weights from ``--seed``, max_seq 2048;
   B=4, T=2048, one fixed batch; ``Trainer.fit`` -> ``lm_loss_fn``
   (plain head) -> ``Transformer`` with ``attn_impl="flash"``;
   ``torch.optim.AdamW(lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
   weight_decay=1e-4, fused=True)``.  One warm-up step, 5 timed: every
   loss finite, the last below the first, 16 launches of each flash
   kernel per step, every parameter and optimizer state on the GPU.
   The counts are set to 0 just before the timed steps, read after.
9. Flash kernels — forward, dq and dk/dv against their plain versions at
   the training shape (B=4, T=2048, H=32, KV=8, D=64, causal) in bf16
   and fp32, plus non-causal, window 256, two packed documents, ALiBi,
   MQA, head_dim 32 and 128, and T=2000.  fp32 within 1e-4 of the
   largest reference magnitude, or absolute below magnitude 1 (dk/dv sum
   G * T products: at MQA, 32 heads of 2048 rows); bf16 within 2e-2 of
   the largest reference magnitude (p and ds are rounded to bf16 before
   their products, and outputs once).  Every case reruns dq and dk/dv:
   the reruns must be bit-identical (no atomics; every sum in a fixed
   order).  In bf16 the three kernels run on tensor cores, in fp32 on
   scalar FMA.  At the
   training shape, times (L2 flushed) of each kernel, its plain
   version, and as the yardstick ``F.scaled_dot_product_attention(...,
   is_causal=True, enable_gqa=True)`` forward and its autograd backward
   (dq + dk + dv in one), with the SDPA kernel that ran; the bound is
   the kernel's FLOPs over the dtype's peak (or its bytes over 3.35
   TB/s if larger).
10. Fused-head reference — the phase-7 model, 3 SGD-momentum steps with
   ``lm_loss_fn(fused_head=True)`` (the fused LM-head CE kernels) and 3
   from the same weights with the plain head; again with
   ``early_exit=(1, 0.5)``.  Losses within 1e-5 relative, step-1
   gradients within 1e-4 of each tensor's largest entry; one forward
   launch and one dx and one dW launch per vocabulary chunk per CE call.
11. Fused-head train (the main path of the fused-CE slice) — phase 8's
   model, seed, batch and AdamW with ``lm_loss_fn(fused_head=True)``:
   one warm-up step, 5 timed; every loss finite, the last below the
   first; the warm-up loss equal to phase 8's within 1e-3 relative (the
   same bf16 operands, fp32 sums in other orders); per step 1 forward,
   16 dx and 16 dW launches of the fused-CE kernels (16 vocabulary
   chunks) and 16 of each flash kernel; no plain version called.
12. Evaluation — ``Trainer.evaluate`` of phase 11's trained model with
   the fused-head loss on 2 fresh batches: only the fused forward kernel
   (and the flash forward) launches; the mean loss equals the plain
   head's under ``no_grad`` within 1e-3 relative; the perplexity.
13. Fused-CE kernels — forward, dlogits + dx and dW against their plain
   versions at the training shape (N=8192, H=2048, V=128256, w the tied
   ``[V, H]`` table's transpose view) in bf16 and fp32, and at N=8188,
   V=50257 (both edges ragged); a quarter of the targets -100, a
   non-uniform loss cotangent.  fp32: lse and loss within 1e-5 relative,
   dx and dW within 1e-4 of the largest reference magnitude; bf16 within
   2e-2 of it (dlogits rounded to bf16 before each product on both
   sides).  At the training shape in bf16, times with the L2 flushed:
   the forward with CUDA events, the backward's kernels by device time
   under ``torch.profiler``, the plain versions, and as yardsticks the
   cuBLAS GEMM of each product alone (``x @ W^T``, ``dlogits @ W``,
   ``dlogits^T @ x``; never called by the port); the bound is the
   kernel's FLOPs over 989 TFLOP/s (or its bytes over 3.35 TB/s if
   larger).

14. Generate reference — the phase-7 fp32 model with
   ``attn_impl="flash"``, B=2, a prompt of 128 (the flash prefill), 32
   new tokens, greedy through ``inference.generate``: a flat cache (the
   decode-attention kernel) and a grouped one (plain dense) give
   identical tokens; so do ``kv_quant=True`` flat (the kernel's int8 mode)
   and grouped (``_cached_attention_q8``).  With ``quantize_params`` (the
   int8 product kernel on every projection) the prefill logits match the
   same model with dequantized float weights within 1e-4 of the largest
   |logit|, and the greedy tokens are identical or ``classify_divergence``
   says "tie".  A seeded sampled run (temperature 0.8, top-k 50, top-p
   0.95) repeats exactly.
15. Generate (the main path of the cached-generation slice) —
   Llama-3.2-1B at full width, bf16 weights from ``--seed``,
   ``attn_impl="flash"``; B=8 prompts of 1920 random tokens, 128 new
   tokens each (``cache_len`` 2048 = max_seq), ``inference.generate``
   greedy: (a) the default layout, flat on the card (the fp kernel), run
   twice — identical tokens, 16 flash-forward launches for the prefill
   and 16 decode-kernel launches per decode step, no plain version
   called; (b) ``cache_layout="grouped"`` (no kernel): its divergence from
   (a) must not be "real"; (c) ``kv_quant=True`` flat (the int8 mode), run
   twice, the same counts; (d) after ``quantize_params``, the flat bf16
   cache, run twice: 112 ``quant_linear`` launches per forward.  Each run
   prints prefill ms, decode ms per token (p50 and max, CUDA events
   between steps), tokens/s, peak memory and launches; counts are set to
   0 just before each run and read just after.  Eight decode steps of (a)
   and of (d) under ``torch.profiler``: kernels and device ms per step,
   the device's idle share, the costliest kernels.
16. Decode-attention kernel — against its plain version at H=32, KV=8,
   D=64, B=8, S=2048: pos 0, 1000 and 2047, window 256, S=2000 (a
   ragged tail), MHA at head_dim 32, head_dim 128, MQA; each in fp32,
   bf16 and int8 with bf16 q.  fp32 within 1e-4 absolute, bf16 and int8
   within 2e-2 of the largest reference magnitude (p is rounded to bf16
   before the PV product at other running maxima).  At pos 2047, with
   the L2 flushed before each call, device time per call from CUDA graphs
   of 20 (flush, call) pairs less the flushes alone (no host gaps between
   launches): the kernel (with its split combine), the plain version, and
   as the yardstick
   (never called by the port) ``F.scaled_dot_product_attention(...,
   enable_gqa=True)`` on the rows ``[:pos+1]`` (dequantized to bf16 for
   the int8 mode); the bound is the attended K/V bytes (and scales) over
   3.35 TB/s.
17. Int8 product kernel — against its plain version at Llama-3.2-1B's
   projection shapes (2048->2048, 2048->512, 2048->8192, 8192->2048) at
   M=8 and M=15360, and the probe's [8, 768] x [768, 3072]; bf16 and fp32
   x, with and without bias.  bf16 within one bf16 ulp of the largest
   output (2^-7 of it: the same rounding points, fp32 sums in other
   orders), fp32 within 1e-5 of it.  bf16 device times per call, the L2
   flushed, from CUDA graphs as in phase 16: the kernel (with its split-K
   combine), the
   plain version, and ``F.linear`` on the dequantized bf16 weight
   (cuBLAS, the yardstick); the bound is max(bytes over 3.35 TB/s,
   FLOPs over 989 TFLOP/s).  The kernels line reports the sum over one
   layer's seven projections at M=8 (a decode step is 16 of them).

The last lines are the card's ``nvidia-smi`` line, one ``{"kernels":
[...]}`` JSON object, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
LLAMA_3_2_1B = dict(
    vocab_size=128256, num_layers=16, num_heads=32, num_kv_heads=8,
    d_model=2048, d_ff=8192, head_dim=64, norm="rmsnorm", norm_eps=1e-5,
    pos_emb="rope", rope_theta=500000.0, mlp="swiglu", tie_embeddings=True,
    rope_scaling=(("factor", 32.0), ("high_freq_factor", 4.0),
                  ("low_freq_factor", 1.0),
                  ("original_max_position_embeddings", 8192),
                  ("rope_type", "llama3")))
MAX_SEQ = 2048  # reduced from the config's 131072
BLOCK = 16
N_SLOTS = 8
PROMPT_LENS = (32, 96, 160, 224, 288, 352, 416, 512)
NEW_TOKENS = 32
TRAIN_REF = dict(vocab_size=1024, num_layers=2, num_heads=4, num_kv_heads=2,
                 d_model=256, d_ff=1024, head_dim=64, max_seq_len=256)
TRAIN_B = 4           # full-width training batch (x MAX_SEQ tokens)
TRAIN_TIMED = 5       # timed steps after one warm-up step
GRAD_TOL = 1e-4       # flash vs local step-1 gradients, of max |g|
KERNEL_SOURCES = ("paged_attention", "flash_attention", "fused_cross_entropy",
                  "decode_attention", "quant_dot")
EVAL_TOL = 1e-3       # fused vs plain head at full width, bf16, relative
GEN_B = 8             # full-width generation: slots
GEN_PROMPT = 1920     # prompt tokens (+ GEN_NEW = MAX_SEQ)
GEN_NEW = 128         # new tokens
INT8_BF16_ULPS = 2    # paged int8 mode, bf16 q: ulps of each row's max


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _line(obj) -> None:
    print(json.dumps(obj), flush=True)


# ----------------------------------------------------------------- build


def _ptxas_entries(log: str) -> dict:
    """ptxas ``-v``'s report per kernel entry: ``{mangled name: {"registers":
    n, "spill_stores": bytes, "spill_loads": bytes}}``."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


FLASH_MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
                     "flash_bwd_dkv_mma_kernel")


def ptxas_phase(logs: dict) -> dict:
    """Registers and spills of the paged kernel and the bf16 flash kernels
    on tensor cores (forward, dq and dk/dv, ``flash_*_mma_kernel<D>``),
    per instantiation; none of the three may spill at head_dim 64 or
    128."""
    info = {"phase": "ptxas"}
    for src, keys in (("paged_attention", ("paged_attention_kernel",)),
                      ("flash_attention", FLASH_MMA_KERNELS)):
        if src not in logs:  # built by an earlier run: no report here
            info[src] = "built earlier; no ptxas report in this process"
            continue
        info[src] = {n: r for n, r in _ptxas_entries(logs[src]).items()
                     if any(key in n for key in keys)}
        for key in keys:
            if not any(key in n for n in info[src]):
                raise AssertionError(f"no {key} in the {src} ptxas report")
    for name, r in (info["flash_attention"].items()
                    if isinstance(info["flash_attention"], dict) else ()):
        # the mangled name carries D as its template argument: Li64E
        if ("Li64E" in name or "Li128E" in name) and (
                r.get("spill_stores") or r.get("spill_loads")):
            raise AssertionError(f"{name} spills: {r}")
    return info


# ------------------------------------------------------------- reference


def reference_phase(torch, seed: int) -> dict:
    """Paged engine (kernel decode) vs a plain dense-cache greedy loop on
    a small fp32 Llama-shaped model: tokens must be identical."""
    import numpy as np

    from byteps_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, init_cache, init_weights)
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    cfg = TransformerConfig(
        **{**LLAMA_3_2_1B, "vocab_size": 1000, "num_layers": 2,
           "num_heads": 8, "num_kv_heads": 2, "d_model": 512,
           "d_ff": 1024, "max_seq_len": 256, "tie_embeddings": False},
        dtype=torch.float32)
    model = Transformer(cfg, device="cuda")
    init_weights(model, seed)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)) for n in
               (20, 37, 64, 90)]
    n_new = 16
    want = []
    for p in prompts:
        caches = init_cache(cfg, 1, len(p) + n_new, device="cuda")
        tok = torch.tensor(p[None], device="cuda")
        logits, _ = model.decode(tok, caches, 0, last_only=True)
        out = []
        for i in range(n_new):
            nxt = int(torch.argmax(logits[0, -1]).item())
            out.append(nxt)
            if i + 1 < n_new:
                logits, _ = model.decode(
                    torch.tensor([[nxt]], device="cuda"), caches,
                    len(p) + i)
        want.append(out)
    eng = ServingEngine(model, n_slots=4, max_seq=256, block=BLOCK,
                        device="cuda", metrics=ServeMetrics())
    reqs = [eng.submit(p, n_new) for p in prompts]
    eng.drain(timeout=300)
    got = [r.result().tolist() for r in reqs]
    if got != want:
        raise AssertionError(f"paged engine tokens {got} != dense "
                             f"reference {want}")
    # the sampled path (temperature, top-k, top-p, the (seed, k) noise
    # chain): two engines, same seeds, must give the same streams
    sampled = []
    for _ in range(2):
        eng_s = ServingEngine(model, n_slots=4, max_seq=256, block=BLOCK,
                              temperature=0.8, top_k=50, top_p=0.95,
                              device="cuda", metrics=ServeMetrics())
        reqs = [eng_s.submit(p, n_new, seed=100 + i)
                for i, p in enumerate(prompts)]
        eng_s.drain(timeout=300)
        sampled.append([r.result().tolist() for r in reqs])
    if sampled[0] != sampled[1]:
        raise AssertionError("seeded sampled streams did not repeat")
    if any(len(t) != n_new or not all(0 <= x < cfg.vocab_size for x in t)
           for t in sampled[0]):
        raise AssertionError(f"bad sampled stream: {sampled[0]}")
    return {"phase": "reference", "requests": len(prompts),
            "new_tokens": n_new, "tokens_identical": True,
            "decode_ticks": eng.decode_ticks,
            "sampled_rerun_identical": True,
            "sampled_differs_from_greedy": sampled[0] != got}


# ----------------------------------------------------------------- serve


def serve_phase(torch, seed: int):
    import numpy as np

    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import (RemoteServeClient, ServeMetrics,
                                          ServingEngine, serve)
    from byteps_tpu_torch.serving import metrics as sm

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16)
    t0 = time.perf_counter()
    # serving keeps its weights in bf16 (no per-tick casts)
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServingEngine(model, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                           block=BLOCK, device="cuda",
                           metrics=ServeMetrics())
    pool_bytes = sum(t.numel() * t.element_size()
                     for layer in engine.pool.caches for t in layer.values())
    on_gpu = (all(p.is_cuda for p in model.parameters())
              and all(t.is_cuda for layer in engine.pool.caches
                      for t in layer.values()))
    if not on_gpu:
        raise AssertionError("model or KV pool is not on the GPU")
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in PROMPT_LENS]
    srv, thread = serve(engine, 0, host="127.0.0.1", in_thread=True)
    addr = f"127.0.0.1:{srv.server_address[1]}"
    runs = []
    try:
        for run in range(2):
            engine.metrics = ServeMetrics()
            results = [None] * len(prompts)
            errors = []

            def one(i):
                try:
                    c = RemoteServeClient(addr, timeout=600)
                    try:
                        results[i] = c.generate(prompts[i], NEW_TOKENS)
                    finally:
                        c.close()
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errors.append(e)

            ticks0 = engine.decode_ticks
            pa.launches = 0
            pa.plain_calls = 0
            t1 = time.perf_counter()
            workers = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=900)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches, plain = pa.launches, pa.plain_calls
            ticks = engine.decode_ticks - ticks0
            if errors:
                raise errors[0]
            if any(w.is_alive() for w in workers):
                raise AssertionError("a serve request did not finish")
            for r in results:
                if r is None or r.shape != (NEW_TOKENS,):
                    raise AssertionError(f"bad result shape: {r}")
                if r.min() < 0 or r.max() >= cfg.vocab_size:
                    raise AssertionError("token id out of range")
            if launches != ticks * cfg.num_layers or ticks == 0:
                raise AssertionError(
                    f"paged_attention launches {launches} != decode "
                    f"ticks {ticks} x {cfg.num_layers} layers")
            if plain:
                raise AssertionError(f"{plain} attention calls ran the "
                                     f"plain version on the CPU")
            summ = engine.metrics.summary()
            runs.append({
                "run": run, "results": results, "launches": launches,
                "decode_ticks": ticks, "wall_s": wall,
                "tokens_per_s": NEW_TOKENS * len(prompts) / wall,
                "ttft_p50_ms": summ["ttft_p50_s"] * 1e3,
                "ttft_p99_ms": summ["ttft_p99_s"] * 1e3,
                "tpot_p50_ms": summ["tpot_p50_s"] * 1e3,
                "tpot_p99_ms": summ["tpot_p99_s"] * 1e3,
                "completed": summ.get(sm.COMPLETED, 0)})
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    for a, b in zip(runs[0]["results"], runs[1]["results"]):
        if not np.array_equal(a, b):
            raise AssertionError("greedy rerun is not token-identical")
    final_pos = [n + NEW_TOKENS - 2 for n in PROMPT_LENS]
    info = {"phase": "serve", "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]},
            "dtype": "bfloat16", "params": n_params,
            "kv_pool_bytes": pool_bytes,
            "kv_blocks": engine.pool.block_stats()["n_blocks"],
            "setup_s": setup_s, "rerun_identical": True,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    for r in runs:
        info[f"run{r['run']}"] = {k: v for k, v in r.items()
                                  if k not in ("run", "results")}
    del model, engine
    torch.cuda.empty_cache()
    return info, runs[-1]["launches"], final_pos


# ---------------------------------------------------------------- kernel


def _kernel_case(torch, np, seed, pos, tq, dtype, H, KV, D, quant=False):
    """q, pools, null-padded tables and cursors at the serving shapes; an
    int8 pool is the fp pool quantized per (position, KV head) with its
    scale pools, the scale rows past each cursor a stale tenant's (1e30:
    the mask must keep them out)."""
    from byteps_tpu_torch.models.transformer import _quantize_kv

    mb = MAX_SEQ // BLOCK
    n_blocks = N_SLOTS * mb + 1
    rng = np.random.RandomState(seed)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn((N_SLOTS, tq, H, D), generator=g, device="cuda")
    ck = torch.randn((n_blocks, BLOCK, KV * D), generator=g, device="cuda")
    cv = torch.randn((n_blocks, BLOCK, KV * D), generator=g, device="cuda")
    table = np.zeros((N_SLOTS, mb), np.int32)  # null-padded tails
    ids = iter(rng.permutation(np.arange(1, n_blocks)))
    for b, p in enumerate(pos):
        for j in range(-(-(p + tq) // BLOCK)):
            table[b, j] = next(ids)
    posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
    tab = torch.from_numpy(table).cuda()
    if not quant:
        return q.to(dtype), ck.to(dtype), cv.to(dtype), tab, posv, {}
    scales = {}
    pools = []
    for name, c in (("k_scale", ck), ("v_scale", cv)):
        qv, sc = _quantize_kv(c.view(n_blocks, BLOCK, KV, D))
        sc[0] = 1e30
        for b, p in enumerate(pos):
            last = p + tq - 1
            sc[table[b, last // BLOCK], last % BLOCK + 1:] = 1e30
        pools.append(qv.view(n_blocks, BLOCK, KV * D))
        scales[name] = sc
    return q.to(dtype), pools[0], pools[1], tab, posv, scales


def _time_ms(torch, fn, flush, iters=20) -> float:
    """ms per call by CUDA events around each call (L2 flushed first) —
    for the paged plain version, which syncs to size its gather and so
    cannot be captured in a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()  # evict the 50 MB L2: decode finds the pool cold
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def _bound(pa, q, pos, tq, window, elt, dtype_name, KV, quant=False):
    B, _, H, D = q.shape
    KVD = KV * D
    nbytes = (pa.kv_bytes_read(pos, tq, BLOCK, KVD, elt, window,
                               kv_heads=KV if quant else 0)
              + 2 * q.numel() * q.element_size()         # q in, out
              + 4 * len(pos)                             # pos
              + 4 * sum(-(-(p + tq) // BLOCK) for p in pos))  # table
    keys = 0
    for p in pos:
        for i in range(tq):
            lo = max(p + i - window + 1, 0) if window else 0
            keys += p + i - lo + 1
    flops = 4 * H * D * keys                             # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def _shard_pools(t, tp):
    """A flat pool (or scale pool) ``[n, block, X]`` cut head-major into
    per-shard pools ``[tp, n, block, X/tp]``."""
    n, blk, x = t.shape
    return t.reshape(n, blk, tp, x // tp).permute(2, 0, 1, 3).contiguous()


def _row_ulps(torch, out, ref) -> float:
    """The largest ``|out - ref|`` in bf16 ulps of its row's largest
    reference magnitude (a row: one query head's D outputs; 8 significant
    bits, so the ulp of [2^e, 2^(e+1)) is 2^(e-7))."""
    top = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return ((out.float() - ref.float()).abs() / ulp).max().item()


def kernel_case(torch, np, name, pos, tq, window, dtype, seed, flush,
                H=32, KV=8, D=64, quant=False, tps=(), timed=True):
    """One paged-attention case against the plain version: fp pools, or
    int8 pools (``quant``) with a q of ``dtype``; with ``tps``, the tp
    wrapper on the same bytes cut into shards must give the unsharded
    launch's output bit for bit.  ``timed``: device ms per call of the
    kernel (and the tp=2 wrapper) and of SDPA on pre-gathered
    (dequantized) rows from CUDA graphs, the plain version's by events."""
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import paged_attention as pa

    dname = str(dtype).split(".")[-1]
    mode = "int8" if quant else dname
    q, ck, cv, table, posv, kw = _kernel_case(torch, np, seed, pos, tq,
                                              dtype, H, KV, D, quant)
    out = pa.paged_attention(q, ck, cv, table, posv, window=window, **kw)
    ref = pa.paged_attention_reference(q, ck, cv, table, posv,
                                       window=window, **kw)
    # int8 with a bf16 q: both sides round p and the output to bf16 at the
    # same points, so each row differs by about one ulp of its magnitude
    ulps = quant and dtype == torch.bfloat16
    tol = (INT8_BF16_ULPS if ulps else
           1e-4 if dtype == torch.float32 else 2e-2)

    def reading(got):
        return (_row_ulps(torch, got, ref) if ulps else
                (got.float() - ref.float()).abs().max().item())

    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out.float()).all() or reading(out) > tol:
        raise AssertionError(f"{name} {mode} q {dname}: max abs err {err} "
                             f"(reading {reading(out)}) > {tol}")
    res = {"case": name, "mode": mode, "q_dtype": dname, "tq": tq,
           "window": window, "heads": [H, KV, D], "max_err": err,
           "tolerance": (f"{tol} bf16 ulps of the row's max |ref|" if ulps
                         else tol)}
    if ulps:
        res["max_err_row_ulps"] = reading(out)
    sharded = {}
    for tp in tps:
        spools = [_shard_pools(t, tp) for t in (ck, cv)]
        skw = {k: _shard_pools(v, tp) for k, v in kw.items()}
        sharded[tp] = (spools, skw)
        before = pa.launches
        got = pa.paged_attention_sharded(q, *spools, table, posv,
                                         window=window, **skw)
        torch.cuda.synchronize()
        if pa.launches != before + 1:  # one launch serves every shard
            raise AssertionError(f"{name}: tp={tp} made "
                                 f"{pa.launches - before} launches")
        res[f"tp{tp}_bit_identical"] = bool(torch.equal(got, out))
        res[f"tp{tp}_max_err"] = (got.float() - ref.float()).abs().max().item()
        if reading(got) > tol:
            raise AssertionError(f"{name} tp={tp}: max abs err "
                                 f"{res[f'tp{tp}_max_err']} (reading "
                                 f"{reading(got)}) > {tol}")
    if not timed:
        return res
    # the yardstick: SDPA over the same keys gathered into dense rows
    # (int8: dequantized to q's dtype)
    B = q.shape[0]
    nb = -(-(max(pos) + tq) // BLOCK)
    S = nb * BLOCK
    idx = table[:, :nb].long()
    kd = ck[idx].reshape(B, S, KV, D)
    vd = cv[idx].reshape(B, S, KV, D)
    if quant:
        kd = (kd.float() * kw["k_scale"][idx].reshape(B, S, KV, 1)).to(dtype)
        vd = (vd.float() * kw["v_scale"][idx].reshape(B, S, KV, 1)).to(dtype)
    kd, vd = (x.transpose(1, 2).contiguous() for x in (kd, vd))
    qd = q.transpose(1, 2).contiguous()
    c = torch.arange(S, device="cuda")
    qpos = posv.long()[:, None] + torch.arange(tq, device="cuda")[None]
    mask = c[None, None, :] <= qpos[:, :, None]
    if window:
        mask = mask & (c[None, None, :] > qpos[:, :, None] - window)
    mask = mask[:, None]                                 # [B, 1, tq, S]
    lib = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                         enable_gqa=True)
    res["library_err"] = (lib.transpose(1, 2).float()
                          - ref.float()).abs().max().item()
    res["kernel_ms"] = _graph_ms(torch, lambda: pa.paged_attention(
        q, ck, cv, table, posv, window=window, **kw), flush)
    if 2 in sharded:
        spools, skw = sharded[2]
        res["tp2_ms"] = _graph_ms(torch, lambda: pa.paged_attention_sharded(
            q, *spools, table, posv, window=window, **skw), flush)
    res["plain_ms"] = _time_ms(torch, lambda: pa.paged_attention_reference(
        q, ck, cv, table, posv, window=window, **kw), flush, iters=5)
    res["library_ms"] = _graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), flush)
    res["bound_ms"], res["bound_by"], res["bytes"] = _bound(
        pa, q, pos, tq, window, ck.element_size(), dname, KV, quant)
    return res


def kernel_phase(torch, seed: int, final_pos):
    import numpy as np

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.RandomState(seed)
    ragged = sorted(int(x) for x in rng.randint(1, 2048, size=N_SLOTS - 2))
    ragged = [1] + ragged + [2047]
    tq5 = [min(p, 2043) for p in ragged]
    cases = []
    for quant in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            # timed: every fp case, and the int8 mode with a bf16 q (the
            # serving dtype); the tp wrapper on the int8 cases
            timed = not quant or dtype == torch.bfloat16
            tps = (2, 4) if quant else ()
            for name, pos, tq, window in (
                    ("ragged_1_2047", ragged, 1, None),
                    ("all_at_2047", [2047] * N_SLOTS, 1, None),
                    ("ragged_tq5", tq5, 5, None),
                    ("all_at_2043_tq5", [2043] * N_SLOTS, 5, None),
                    ("ragged_window256", ragged, 1, 256),
                    ("ragged_tq5_window256", tq5, 5, 256)):
                cases.append(kernel_case(torch, np, name, pos, tq, window,
                                         dtype, seed, flush, quant=quant,
                                         tps=tps, timed=timed))
                _line(cases[-1])
            # the serve role's default model: 4 heads of 32, MHA
            cases.append(kernel_case(torch, np, "serve_default_head_dim32",
                                     ragged, 1, None, dtype, seed, flush,
                                     H=4, KV=4, D=32, quant=quant,
                                     tps=(2, 4) if quant else (),
                                     timed=timed))
            _line(cases[-1])
    main = kernel_case(torch, np, "serve_last_tick", final_pos, 1, None,
                       torch.bfloat16, seed, flush)
    _line(main)
    return cases, main


# ------------------------------------------------------------- serve role


def serve_role_phase(torch, extra=None) -> dict:
    """``DMLC_ROLE=serve`` with its defaults (plus ``extra`` knobs): the
    head_dim-32 model on the GPU, greedy reruns identical, decoding
    through the kernel.  With the tiers' knobs the second request is a
    prefix hit and every tick a verify pass over the tp-sharded int8
    pool."""
    import os

    import numpy as np

    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import RemoteServeClient
    from byteps_tpu_torch.serving.frontend import serve_from_env

    env = {"BYTEPS_SERVE_PAGED": "1", **(extra or {})}
    os.environ.pop("BYTEPS_SERVE_MODEL", None)
    pa.launches = 0
    pa.plain_calls = 0
    srv, thread = serve_from_env(env, port=0, in_thread=True)
    try:
        eng = srv.engine
        cfg = eng.model.cfg
        c = RemoteServeClient(f"127.0.0.1:{srv.server_address[1]}",
                              timeout=300)
        prompt = np.arange(1, 40, dtype=np.int32) % 7
        a, b = c.generate(prompt, 8), c.generate(prompt, 8)
        st = c.stats()
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        for k in env:
            os.environ.pop(k, None)
        reset_config()
    torch.cuda.synchronize()
    if cfg.d_head != 32 or not st["device"].startswith("cuda"):
        raise AssertionError(f"serve role ran head_dim {cfg.d_head} on "
                             f"{st['device']}")
    counts = st["step_counts"]
    if (a.shape != (8,) or not np.array_equal(a, b) or pa.plain_calls
            or pa.launches != counts["decode_ticks"] * cfg.num_layers
            or pa.launches == 0):  # one launch per layer a tick at any tp
        raise AssertionError(f"serve role: {a} / {b}, {pa.launches} kernel "
                             f"launches, {pa.plain_calls} plain, {counts}")
    info = {"phase": "serve_role", "env": env, "head_dim": cfg.d_head,
            "device": st["device"], "tokens_identical": True,
            "paged_launches": pa.launches, "step_counts": counts,
            "kv_blocks": st["kv_blocks"], "prefix_cache": st["prefix_cache"]}
    if extra:
        pool = eng.pool.caches[0]["k"]
        if (eng.tp != int(extra["BYTEPS_TP"]) or pool.shape[0] != eng.tp
                or pool.dtype != torch.int8
                or st["prefix_cache"]["hits"] < 1
                or counts["verify_ticks"] != counts["decode_ticks"]):
            raise AssertionError(f"serve role tiers: tp {eng.tp}, pool "
                                 f"{tuple(pool.shape)} {pool.dtype}, "
                                 f"{st['prefix_cache']}, {counts}")
    return info


# ------------------------------------------------------- serving tiers

TIERS_KV_MB = 513    # phase 4's 1025-block bf16 pool (537.4 MB), whole MiB
TIERS_SPEC_K = 4
TIERS_SHARED = 256   # shared prefix tokens of every prompt
TIERS_RUN = 8        # the run each prompt ends with, twice
TIERS_ROLE_ENV = {"BYTEPS_SERVE_KV_DTYPE": "int8", "BYTEPS_TP": "2",
                  "BYTEPS_SERVE_PREFIX_CACHE": "1", "BYTEPS_SERVE_SPEC": "1"}


def tiers_reference_phase(torch, seed: int) -> dict:
    """The serving tiers on the phase-3 fp32 model: int8 pools (kernel)
    vs a plain dense int8 loop; tp=2 vs tp=1 (fp and int8); prefix cache
    on vs off; speculation on vs off (greedy and seeded)."""
    import numpy as np

    from byteps_tpu_torch.inference import generate
    from byteps_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, init_cache, init_weights)
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    cfg = TransformerConfig(
        **{**LLAMA_3_2_1B, "vocab_size": 1000, "num_layers": 2,
           "num_heads": 8, "num_kv_heads": 2, "d_model": 512,
           "d_ff": 1024, "max_seq_len": 256, "tie_embeddings": False},
        dtype=torch.float32)
    model = Transformer(cfg, device="cuda")
    init_weights(model, seed)
    rng = np.random.RandomState(seed + 7)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)) for n in
               (20, 37, 64, 90)]
    n_new = 16

    def engine(**kw):
        return ServingEngine(model, n_slots=4, max_seq=256, block=BLOCK,
                             device="cuda", metrics=ServeMetrics(), **kw)

    def run(eng, ps, seeds=None, one_by_one=False):
        reqs = []
        for i, p in enumerate(ps):
            reqs.append(eng.submit(p, n_new, seed=seeds[i] if seeds else 0))
            if one_by_one:
                eng.drain(timeout=300)
        eng.drain(timeout=300)
        return [r.result().tolist() for r in reqs]

    # the plain int8 loop: the prompt quantized at write and attended as
    # int8 like every later step (the paged chunk's rule), no kernel
    want = []
    for p in prompts:
        caches = init_cache(cfg, 1, len(p) + n_new, quantized=True,
                            layout="grouped", device="cuda")
        logits, _ = model.decode(torch.tensor(p[None], device="cuda"),
                                 caches, 0, last_only=True,
                                 fresh_prefill=False)
        out = []
        for i in range(n_new):
            out.append(int(torch.argmax(logits[0, -1]).item()))
            if i + 1 < n_new:
                logits, _ = model.decode(
                    torch.tensor([[out[-1]]], device="cuda"), caches,
                    len(p) + i)
        want.append(out)
    info = {"phase": "tiers_reference"}
    launches0 = pa.launches
    int8 = run(engine(kv_dtype="int8"), prompts)
    if int8 != want:
        raise AssertionError(f"int8 engine {int8} != plain int8 loop {want}")
    if pa.launches == launches0:
        raise AssertionError("the int8 engine launched no kernel")
    # generate(kv_quant=True) attends its prompt unquantized (JAX's
    # static pos=0 path), so it may differ from the int8 pool: reported
    gq = generate(model, np.stack([np.asarray(p) for p in prompts[:1]]),
                  n_new, temperature=0.0, kv_quant=True,
                  cache_layout="grouped")["tokens"]
    info["generate_kv_quant_identical"] = gq[0].tolist() == int8[0]
    info["int8_vs_plain_loop_identical"] = True
    fp = run(engine(), prompts)
    for kv in ("", "int8"):
        base = fp if not kv else int8
        if run(engine(kv_dtype=kv, tp=2), prompts) != base:
            raise AssertionError(f"tp=2 ({kv or 'fp'}) != tp=1")
    info["tp2_identical"] = True
    shared = rng.randint(0, cfg.vocab_size, size=(64,))
    prefixed = [np.concatenate([shared, p[:10]]) for p in prompts]
    eng_p = engine(prefix_cache=True, kv_dtype="int8")
    got = run(eng_p, prefixed, one_by_one=True)
    if got != run(engine(kv_dtype="int8"), prefixed):
        raise AssertionError("prefix cache on != off")
    if eng_p.prefix_hits < 3:
        raise AssertionError(f"{eng_p.prefix_hits} prefix hits")
    info["prefix_identical"] = True
    info["prefix_hits"] = eng_p.prefix_hits
    rep = [np.tile(p[:8], 4) for p in prompts]
    for kv in ("", "int8"):
        eng_s = engine(spec_k=TIERS_SPEC_K, kv_dtype=kv)
        if run(eng_s, rep) != run(engine(kv_dtype=kv), rep):
            raise AssertionError(f"spec on != off ({kv or 'fp'}, greedy)")
        info[f"spec_counts_{kv or 'fp'}"] = eng_s.step_counts()
    kw = dict(temperature=0.8, top_k=50, top_p=0.95)
    seeds = [100 + i for i in range(len(rep))]
    on = run(engine(spec_k=TIERS_SPEC_K, **kw), rep, seeds)
    if on != run(engine(**kw), rep, seeds):
        raise AssertionError("spec on != off (seeded)")
    info["spec_identical"] = {"greedy": True, "seeded": True}
    del model
    torch.cuda.empty_cache()
    return info


def _tiers_prompts(np, vocab, seed):
    """9 base prompts (a warm one, then 8): a shared 256-token prefix,
    64-256 unique tokens, and an 8-token run repeated twice."""
    rng = np.random.RandomState(seed + 11)
    shared = rng.randint(0, vocab, size=(TIERS_SHARED,))
    out = []
    for n in np.linspace(64, 256, 9).astype(int):
        run = rng.randint(0, vocab, size=(TIERS_RUN,))
        out.append(np.concatenate([shared, rng.randint(0, vocab, size=(n,)),
                                   run, run]).astype(np.int32))
    return out[0], out[1:]


def _tiers_engine(model, tp):
    from byteps_tpu_torch.serving import ServeMetrics, ServingEngine

    return ServingEngine(model, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                         block=BLOCK, kv_mb=TIERS_KV_MB, kv_dtype="int8",
                         tp=tp, prefix_cache=True, spec_k=TIERS_SPEC_K,
                         device="cuda", metrics=ServeMetrics())


class _ReplayProposer:
    """Proposes each request's reference answer (a first run's tokens) —
    the accept path at full width.  Random weights never accept their
    own n-gram proposals: their near-tied logits make the answer change
    with any change of its context, so no copy of it can sit in a
    prompt.  Every row of a verify pass is computed as it would be
    alone, so replayed proposals must be accepted and must give the
    reference tokens.  ``k`` is the engine's proposer's."""

    def __init__(self, k, prompts, answers):
        self.k = k
        self._ref = {p.tobytes(): a for p, a in zip(prompts, answers)}
        self._lens = sorted({len(p) for p in prompts})

    def propose(self, context, max_tokens):
        for n in self._lens:
            ans = self._ref.get(context[:n].tobytes())
            if ans is not None:
                break
        else:
            return []
        done = len(context) - n                    # tokens emitted so far
        if not (context[n:] == ans[:done]).all():
            return []
        return [int(t) for t in ans[done:done + min(self.k, max_tokens)]]


def _tiers_run(torch, np, model, prompts, warm, tp, replay=None):
    """One engine (int8 pool, prefix cache, speculation, tp) behind a
    ServeFrontend: the warm request, then 8 concurrent ones; the kernel
    counts set to 0 just before and read just after.  ``replay`` (the
    first run's answers) swaps the n-gram proposer for a
    :class:`_ReplayProposer`, whose proposals must be accepted."""
    from byteps_tpu_torch.ops import paged_attention as pa
    from byteps_tpu_torch.serving import RemoteServeClient, serve

    engine = _tiers_engine(model, tp)
    if replay is not None:
        engine.spec = _ReplayProposer(engine.spec.k, [warm] + prompts,
                                      replay)
    if not all(t.is_cuda for layer in engine.pool.caches
               for t in layer.values()):
        raise AssertionError("KV pool is not on the GPU")
    srv, thread = serve(engine, 0, host="127.0.0.1", in_thread=True)
    addr = f"127.0.0.1:{srv.server_address[1]}"
    results = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            c = RemoteServeClient(addr, timeout=600)
            try:
                results[i] = c.generate(prompts[i], NEW_TOKENS)
            finally:
                c.close()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    try:
        pa.launches = 0
        pa.plain_calls = 0
        c = RemoteServeClient(addr, timeout=600)
        warm_out = c.generate(warm, NEW_TOKENS)
        c.close()
        t1 = time.perf_counter()
        workers = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches, plain = pa.launches, pa.plain_calls
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    if errors:
        raise errors[0]
    if any(w.is_alive() for w in workers):
        raise AssertionError("a serve request did not finish")
    cfg = model.cfg
    for r in [warm_out] + results:
        if r is None or r.shape != (NEW_TOKENS,) or r.min() < 0 \
                or r.max() >= cfg.vocab_size:
            raise AssertionError(f"bad result: {r}")
    counts = engine.step_counts()
    if (launches != counts["decode_ticks"] * cfg.num_layers  # any tp
            or counts["verify_ticks"] != counts["decode_ticks"] or plain
            or (replay is not None and not counts["spec_accepted"])):
        raise AssertionError(f"tp={tp}: {launches} launches, {plain} plain "
                             f"calls, {counts}")
    if counts["prefix_hits"] < len(prompts):
        raise AssertionError(f"{counts['prefix_hits']} prefix hits")
    summ = engine.metrics.summary()
    final_pos = [len(p) + NEW_TOKENS - 2 for p in prompts]
    out = {"tp": tp, "proposer": "ngram" if replay is None else "replay",
           "results": [warm_out] + results, "launches": launches,
           "step_counts": counts, "wall_s": wall,
           "tokens_per_s": NEW_TOKENS * len(prompts) / wall,
           "ttft_p50_ms": summ["ttft_p50_s"] * 1e3,
           "ttft_p99_ms": summ["ttft_p99_s"] * 1e3,
           "tpot_p50_ms": summ["tpot_p50_s"] * 1e3,
           "tpot_p99_ms": summ["tpot_p99_s"] * 1e3,
           "spec_acceptance": (counts["spec_accepted"]
                               / max(counts["spec_proposed"], 1)),
           "kv_blocks": engine.pool.block_stats(),
           "prefix_cache": engine.prefix.stats(), "final_pos": final_pos}
    del engine
    torch.cuda.empty_cache()
    return out


def tiers_serve_phase(torch, seed: int):
    """The main path of the tiers slice at full width: Llama-3.2-1B bf16
    behind a ServeFrontend on an int8 pool with the prefix cache and
    speculation, twice at tp=1 (fresh engines: identical tokens), then
    at tp=2 (identical to tp=1)."""
    import numpy as np

    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    warm, prompts = _tiers_prompts(np, cfg.vocab_size, seed)
    runs = [_tiers_run(torch, np, model, prompts, warm, tp) for tp in (1, 2)]
    ref = runs[0]["results"]
    runs += [_tiers_run(torch, np, model, prompts, warm, tp, replay=ref)
             for tp in (1, 2)]
    for r in runs[1:]:
        for a, b in zip(ref, r["results"]):
            if not np.array_equal(a, b):
                raise AssertionError(f"tp={r['tp']} run is not "
                                     f"token-identical to the first")
    bf16_block = cfg.num_layers * 2 * BLOCK * cfg.kv_heads * cfg.d_head * 2
    info = {"phase": "tiers_serve", "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]}, "dtype": "bfloat16",
            "kv_mb": TIERS_KV_MB, "spec_k": TIERS_SPEC_K,
            "prompt_lens": [len(warm)] + [len(p) for p in prompts],
            "int8_blocks": runs[0]["kv_blocks"]["n_blocks"],
            "bf16_blocks": (TIERS_KV_MB << 20) // bf16_block,
            "rerun_identical": True, "tp2_identical": True,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    info["blocks_ratio"] = info["int8_blocks"] / info["bf16_blocks"]
    for i, r in enumerate(runs):
        info[f"run{i}_tp{r['tp']}_{r['proposer']}"] = {
            k: v for k, v in r.items() if k not in ("results", "final_pos")}
    del model
    torch.cuda.empty_cache()
    return info, runs[0], runs[1]


def tiers_kernel_phase(torch, seed: int, final_pos) -> dict:
    """The int8 mode and the tp=2 wrapper at the tiers run's last decode
    cursors (bf16 q): the kernels line's row-8 int8 and tp entries."""
    import numpy as np

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    main = kernel_case(torch, np, "tiers_last_tick", final_pos, 1, None,
                       torch.bfloat16, seed, flush, quant=True, tps=(2,))
    _line(main)
    return main


# -------------------------------------------------------------- training


def _flash_counts():
    from byteps_tpu_torch.ops import flash_attention as fa

    return (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)


def _zero_counts():
    """Every launch and plain-call count of the flash, fused-CE, decode
    and int8-product wrappers to 0."""
    from byteps_tpu_torch.ops import decode_attention as da
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import fused_cross_entropy as fce
    from byteps_tpu_torch.ops import quant_dot as qd

    fa.fwd_launches = fa.dq_launches = fa.dkv_launches = fa.plain_calls = 0
    fce.fwd_launches = fce.dx_launches = fce.dw_launches = 0
    fce.plain_calls = 0
    da.launches = da.plain_calls = 0
    qd.launches = qd.plain_calls = 0


def _fce_counts():
    from byteps_tpu_torch.ops import fused_cross_entropy as fce

    return (fce.fwd_launches, fce.dx_launches, fce.dw_launches)


def train_reference_phase(torch, seed: int) -> dict:
    """3 fp32 steps with the flash kernels vs 3 with the plain local
    attention, same weights and batch: losses and step-1 gradients."""
    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    toks = np.random.RandomState(seed).randint(
        0, TRAIN_REF["vocab_size"], size=(2, TRAIN_REF["max_seq_len"]))
    runs = {}
    for impl in ("flash", "local"):
        cfg = TransformerConfig(**{**LLAMA_3_2_1B, **TRAIN_REF},
                                attn_impl=impl, dtype=torch.float32)
        model = Transformer(cfg, device="cuda")
        init_weights(model, seed)
        trainer = Trainer(lm_loss_fn(model), torch.optim.SGD(
            model.parameters(), lr=0.05, momentum=0.9), log_every=0)
        _zero_counts()
        losses, grads = [], None
        for step in range(3):
            trainer.fit(model, {}, [{"tokens": toks}])
            losses.append(trainer.metrics["loss"].item())
            if step == 0:
                grads = {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}
        runs[impl] = (losses, grads, _flash_counts())
        api.shutdown()
        del model, trainer
    (lf, gf, nf), (ll, gl, nl) = runs["flash"], runs["local"]
    want = 3 * TRAIN_REF["num_layers"]
    if nf != (want, want, want) or nl != (0, 0, 0):
        raise AssertionError(f"flash launches {nf} (want {want} each), "
                             f"local {nl}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, ll))
    if not all(np.isfinite(lf)) or loss_rel > 1e-5:
        raise AssertionError(f"losses flash {lf} vs local {ll}")
    grad_rel = max(((gf[n] - gl[n]).abs().max()
                    / gl[n].abs().max().clamp(min=1e-30)).item() for n in gl)
    if grad_rel > GRAD_TOL:
        raise AssertionError(f"step-1 gradients differ by {grad_rel} of "
                             f"their largest entry (> {GRAD_TOL})")
    torch.cuda.empty_cache()
    return {"phase": "train_reference", "losses_flash": lf,
            "losses_local": ll, "loss_max_rel_diff": loss_rel,
            "grad_max_rel_diff": grad_rel, "grad_tolerance": GRAD_TOL,
            "flash_launches": nf}


def fused_reference_phase(torch, seed: int) -> dict:
    """3 fp32 steps with the fused LM-head CE kernels vs 3 with the plain
    head from the same weights, then both again with the early-exit
    term: losses and step-1 gradients."""
    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import fused_cross_entropy as fce
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    toks = np.random.RandomState(seed).randint(
        0, TRAIN_REF["vocab_size"], size=(2, TRAIN_REF["max_seq_len"]))
    cfg = TransformerConfig(**{**LLAMA_3_2_1B, **TRAIN_REF},
                            attn_impl="flash", dtype=torch.float32)
    nc = fce.vocab_chunks(cfg.vocab_size)
    info = {"phase": "fused_reference"}
    for early_exit in (None, (1, 0.5)):
        runs = {}
        for fused in (True, False):
            model = Transformer(cfg, device="cuda")
            init_weights(model, seed)
            trainer = Trainer(
                lm_loss_fn(model, fused_head=fused, early_exit=early_exit),
                torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
                log_every=0)
            _zero_counts()
            losses, grads = [], None
            for step in range(3):
                trainer.fit(model, {}, [{"tokens": toks}])
                losses.append(trainer.metrics["loss"].item())
                if step == 0:
                    grads = {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}
            runs[fused] = (losses, grads, _fce_counts(), fce.plain_calls)
            api.shutdown()
            del model, trainer
        (lf, gf, nf, pf), (lp, gp, np_, pp) = runs[True], runs[False]
        calls = 3 * (1 if early_exit is None else 2)  # CE calls in 3 steps
        if nf != (calls, calls * nc, calls * nc) or np_ != (0, 0, 0) \
                or pf or pp:
            raise AssertionError(f"fused-CE launches {nf} (want {calls}, "
                                 f"{calls * nc} x2), plain head {np_}, "
                                 f"plain calls {pf}/{pp}")
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, lp))
        if not all(np.isfinite(lf)) or loss_rel > 1e-5:
            raise AssertionError(f"losses fused {lf} vs plain {lp}")
        grad_rel = max(((gf[n] - gp[n]).abs().max()
                        / gp[n].abs().max().clamp(min=1e-30)).item()
                       for n in gp)
        if grad_rel > GRAD_TOL:
            raise AssertionError(f"step-1 gradients differ by {grad_rel} "
                                 f"of their largest entry (> {GRAD_TOL})")
        tag = "" if early_exit is None else "early_exit_"
        info.update({f"{tag}losses_fused": lf, f"{tag}losses_plain": lp,
                     f"{tag}loss_max_rel_diff": loss_rel,
                     f"{tag}grad_max_rel_diff": grad_rel,
                     f"{tag}fce_launches": nf})
    torch.cuda.empty_cache()
    return info


def train_phase(torch, seed: int, fused_head: bool = False, then=None):
    """Full-width Llama-3.2-1B training through Trainer.fit: the main
    path of the training slice, or with ``fused_head`` that of the
    fused-CE slice.  ``then(trainer, model)``, if given, runs on the
    trained model before it is freed; its result is returned third."""
    import numpy as np

    from byteps_tpu_torch import api
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import fused_cross_entropy as fce
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    nc = fce.vocab_chunks(cfg.vocab_size)
    want = (cfg.num_layers,) * 3 + ((1, nc, nc) if fused_head else (0, 0, 0))
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda")            # fp32 weights
    init_weights(model, seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4, fused=True)
    trainer = Trainer(lm_loss_fn(model, fused_head=fused_head), opt,
                      log_every=0)
    toks = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(TRAIN_B, MAX_SEQ))
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(model, {}, [batch])                     # warm-up
    losses = [trainer.metrics["loss"].item()]
    _zero_counts()
    step_ms = []
    for _ in range(TRAIN_TIMED):
        before = _flash_counts() + _fce_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.fit(model, {}, [batch])
        losses.append(trainer.metrics["loss"].item())   # synchronizes
        step_ms.append((time.perf_counter() - t1) * 1e3)
        per = tuple(a - b for a, b in zip(_flash_counts() + _fce_counts(),
                                          before))
        if per != want:
            raise AssertionError(f"launches this step (flash fwd/dq/dkv, "
                                 f"fused CE fwd/dx/dw) {per}, want {want}")
    launches = _flash_counts() + _fce_counts()
    if fa.plain_calls or fce.plain_calls:
        raise AssertionError(f"{fa.plain_calls} flash and {fce.plain_calls} "
                             f"fused-CE calls ran the plain version")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite and falling")
    on_gpu = all(p.is_cuda for p in model.parameters()) and all(
        t.is_cuda for st in opt.state.values() for t in st.values()
        if torch.is_tensor(t))
    if not on_gpu or len(opt.state) != len(list(model.parameters())):
        raise AssertionError("a parameter or optimizer state is not on "
                             "the GPU")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_B * MAX_SEQ
    info = {"phase": "train_fused_head" if fused_head else "train",
            "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]},
            "dtype": "bfloat16 compute, float32 weights",
            "params": n_params, "batch": [TRAIN_B, MAX_SEQ],
            "optimizer": "AdamW lr 1e-4 wd 1e-4 (fused)",
            "setup_s": setup_s, "losses": losses,
            "step_ms_p50": float(np.median(step_ms)),
            "step_ms_max": float(np.max(step_ms)), "step_ms": step_ms,
            "tokens_per_s": tokens / (float(np.median(step_ms)) / 1e3),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "flash_launches": launches[:3], "fce_launches": launches[3:]}
    extra = then(trainer, model) if then is not None else None
    api.shutdown()
    del model, opt, trainer, batch
    torch.cuda.empty_cache()
    return info, launches, extra


def eval_phase(torch, seed: int, trainer, model) -> dict:
    """Trainer.evaluate with the fused-head loss on 2 fresh full-width
    batches: the forward kernel only, the plain head's mean loss."""
    import numpy as np

    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import fused_cross_entropy as fce
    from byteps_tpu_torch.training import lm_loss_fn

    rng = np.random.RandomState(seed + 1)
    batches = [{"tokens": rng.randint(0, model.cfg.vocab_size,
                                      size=(TRAIN_B, MAX_SEQ))}
               for _ in range(2)]
    fused = lm_loss_fn(model, fused_head=True)
    _zero_counts()
    t0 = time.perf_counter()
    out = trainer.evaluate(
        lambda st, b: {"loss": fused(st.model, {}, b)[0]}, batches)
    eval_s = time.perf_counter() - t0
    counts = _flash_counts() + _fce_counts()
    want = (2 * model.cfg.num_layers, 0, 0, 2, 0, 0)  # forward kernels only
    if counts != want or fa.plain_calls or fce.plain_calls:
        raise AssertionError(f"evaluate launched (flash fwd/dq/dkv, fused CE "
                             f"fwd/dx/dw) {counts}, want {want}")
    plain = lm_loss_fn(model)
    with torch.no_grad():
        want = float(np.mean([plain(model, {}, {
            "tokens": torch.from_numpy(b["tokens"]).cuda()})[0].item()
            for b in batches]))
    rel = abs(out["loss"] - want) / abs(want)
    if not np.isfinite(out["loss"]) or rel > EVAL_TOL:
        raise AssertionError(f"evaluate loss {out['loss']} vs plain head "
                             f"{want}: {rel} > {EVAL_TOL}")
    return {"phase": "evaluate", "batches": len(batches),
            "loss_fused": out["loss"], "loss_plain_head": want,
            "rel_diff": rel, "tolerance": EVAL_TOL,
            "perplexity": float(np.exp(out["loss"])), "seconds": eval_s,
            "launches": counts}


# --------------------------------------------------------- flash kernels

FLASH_MAIN = dict(B=TRAIN_B, T=MAX_SEQ, H=32, KV=8, D=64, causal=True,
                  window=None, seg=False, alibi=False)
FLASH_CASES = (("training_shape", {}), ("noncausal", {"causal": False}),
               ("window256", {"window": 256}), ("two_documents", {"seg": True}),
               ("alibi", {"alibi": True}), ("mqa", {"KV": 1}),
               ("head_dim32", {"D": 32}), ("head_dim128", {"D": 128}),
               ("t2000", {"T": 2000}))


def _flash_inputs(torch, seed, c, dtype):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def t(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    B, T, H, KV, D = c["B"], c["T"], c["H"], c["KV"], c["D"]
    q, k, v, do = t(B, T, H, D), t(B, T, KV, D), t(B, T, KV, D), t(B, T, H, D)
    seg = None
    if c["seg"]:
        cut = torch.tensor([T // 3 + 97 * b for b in range(B)], device="cuda")
        seg = (torch.arange(T, device="cuda")[None] >= cut[:, None]).to(
            torch.int32)
    slopes = (2.0 ** -torch.arange(1, H + 1, device="cuda").float()
              if c["alibi"] else None)
    return q, k, v, do, seg, slopes


def _bounds(flops, nbytes, elt):
    """Least time (ms) of each kernel: max(FLOPs / the dtype's peak,
    bytes / HBM rate), and which of the two it is."""
    peak = PEAK_FLOPS["bfloat16" if elt == 2 else "float32"]
    out = {}
    for n in flops:
        t_ops = flops[n] / peak * 1e3
        t_bytes = nbytes[n] / HBM_BYTES_PER_S * 1e3
        out[n] = (max(t_ops, t_bytes),
                  "operations" if t_ops >= t_bytes else "bytes")
    return out


def _flash_bounds(fa, c, elt):
    """Least time (ms) for each kernel: max(FLOPs / peak, bytes / HBM)."""
    B, T, H, KV, D = c["B"], c["T"], c["H"], c["KV"], c["D"]
    flops = fa.attention_flops(B, T, H, D, c["causal"], c["window"])
    q_bytes, kv_bytes, row_bytes = B * T * H * D * elt, B * T * KV * D * elt, \
        B * H * T * 4
    nbytes = {"fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,       # q k v o lse
              "dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,    # q do dq k v
              "dkv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes}   # q do k v dk dv
    return _bounds(flops, nbytes, elt)


def _kernel_us(torch, fn, flush=None, reps=1) -> dict:
    """Device microseconds per call of ``fn`` by CUDA kernel name, under
    torch.profiler (the L2 flushed before each call if ``flush``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {n: t / reps for n, t in times.items()}


def _graph_ms(torch, fn, flush, iters=20, reps=3) -> float:
    """Device ms per call of ``fn`` with the L2 flushed before each call,
    without the host's gaps between launches (which a call of a few
    microseconds can be shorter than): ``iters`` (flush, call) pairs are
    captured in one CUDA graph, and its best replay of ``reps``, timed with
    CUDA events, less the best replay of a graph of the flushes alone, is
    divided by ``iters``."""
    def replay_ms(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm-up off the capture
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        best = float("inf")
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1))
        del graph
        return best

    def calls():
        for _ in range(iters):
            flush.zero_()
            fn()

    def flushes():
        for _ in range(iters):
            flush.zero_()

    return (replay_ms(calls) - replay_ms(flushes)) / iters


def _sdpa_kernels(torch, fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` ran, by device time."""
    times = _kernel_us(torch, fn)
    return [n[:80] for n, _ in sorted(times.items(), key=lambda kv: -kv[1])][:3]


def flash_case(torch, name, over, dtype, seed, flush, timed):
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import flash_attention as fa

    c = {**FLASH_MAIN, **over}
    dname = str(dtype).split(".")[-1]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q, k, v, do, seg, slopes = _flash_inputs(torch, seed, c, dtype)
    opts = (c["causal"], None, seg, c["window"], slopes)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, *opts)
    delta = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    bwd = (q, k, v, do, lse_ref, delta)
    outs = {"fwd": fa.flash_forward(q, k, v, *opts),
            "dq": (fa.flash_backward_dq(*bwd, *opts),),
            "dkv": fa.flash_backward_dkv(*bwd, *opts)}
    refs = {"fwd": (o_ref, lse_ref),
            "dq": (fa.flash_backward_dq_reference(*bwd, *opts),),
            "dkv": fa.flash_backward_dkv_reference(*bwd, *opts)}
    torch.cuda.synchronize()
    res = {"case": name, "dtype": dname,
           "B_T_H_KV_D": [c["B"], c["T"], c["H"], c["KV"], c["D"]],
           "causal": c["causal"], "window": c["window"], "segments": c["seg"],
           "alibi": c["alibi"], "tolerance": tol}
    # reruns give the same bits: no atomics, every sum in a fixed order
    again = {"dq": (fa.flash_backward_dq(*bwd, *opts),),
             "dkv": fa.flash_backward_dkv(*bwd, *opts)}
    res["rerun_bit_identical"] = {
        n: torch.equal(a, b) for kname in again
        for n, a, b in zip(("dq",) if kname == "dq" else ("dk", "dv"),
                           outs[kname], again[kname])}
    if not all(res["rerun_bit_identical"].values()):
        raise AssertionError(f"flash backward {name} {dname}: a rerun "
                             f"differs: {res['rerun_bit_identical']}")
    for kname in ("fwd", "dq", "dkv"):
        abs_err = rel_err = 0.0
        for out, ref in zip(outs[kname], refs[kname]):
            if not (torch.isfinite(out.float()).all()
                    and torch.isfinite(ref.float()).all()):
                raise AssertionError(f"flash {kname} {name} {dname}: "
                                     f"non-finite output")
            e = (out.float() - ref.float()).abs().max().item()
            abs_err = max(abs_err, e)
            top = ref.float().abs().max().item()
            rel_err = max(rel_err, e / (max(top, 1e-6)
                                        if out.dtype == torch.bfloat16
                                        else max(top, 1.0)))
        if rel_err > tol:
            raise AssertionError(f"flash {kname} {name} {dname}: error "
                                 f"{rel_err} > {tol}")
        res[f"{kname}_max_abs_err"] = abs_err
        res[f"{kname}_err"] = rel_err
    if not timed:
        return res
    kern = {"fwd": lambda: fa.flash_forward(q, k, v, *opts),
            "dq": lambda: fa.flash_backward_dq(*bwd, *opts),
            "dkv": lambda: fa.flash_backward_dkv(*bwd, *opts)}
    plain = {"fwd": lambda: fa.flash_forward_reference(q, k, v, *opts),
             "dq": lambda: fa.flash_backward_dq_reference(*bwd, *opts),
             "dkv": lambda: fa.flash_backward_dkv_reference(*bwd, *opts)}
    bounds = _flash_bounds(fa, c, q.element_size())
    for kname in kern:
        res[f"{kname}_ms"] = _time_ms(torch, kern[kname], flush, iters=10)
        res[f"{kname}_plain_ms"] = _time_ms(torch, plain[kname], flush,
                                            iters=5)
        res[f"{kname}_bound_ms"], res[f"{kname}_bound_by"] = bounds[kname]
    # the yardstick: one PyTorch call for the same function
    qd, kd, vd = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dod = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qd, kd, vd, is_causal=True,
                                              enable_gqa=True)

    out = sdpa()
    res["library_fwd_ms"] = _time_ms(torch, sdpa, flush, iters=10)
    res["library_bwd_ms"] = _time_ms(torch, lambda: torch.autograd.grad(
        out, (qd, kd, vd), dod, retain_graph=True), flush, iters=10)
    res["library_fwd_err"] = (out.detach().transpose(1, 2).float()
                              - o_ref.float()).abs().max().item()
    res["library_fwd_kernels"] = _sdpa_kernels(torch, sdpa)
    res["library_bwd_kernels"] = _sdpa_kernels(torch, lambda: torch.autograd
                                               .grad(out, (qd, kd, vd), dod,
                                                     retain_graph=True))
    return res


def flash_kernel_phase(torch, seed: int):
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, over in FLASH_CASES:
            r = flash_case(torch, name, over, dtype, seed, flush,
                           timed=not over)
            _line(r)
            if not over and dtype == torch.bfloat16:
                main = r
            torch.cuda.empty_cache()
    return main


# ------------------------------------------------------- fused-CE kernels

FCE_MAIN = dict(N=TRAIN_B * MAX_SEQ, H=2048, V=128256)
FCE_CASES = (("training_shape", {}),
             ("ragged_8188_50257", {"N": 8188, "V": 50257}))
FCE_KERNELS = ("fce_dlogits_kernel", "fce_dx_kernel", "fce_dw_kernel")


def _fce_inputs(torch, seed, c, dtype):
    """x [N, H], the head table [V, H] (w is its transpose view), targets
    with every 4th row -100, a non-uniform cotangent zero on those."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    N, H, V = c["N"], c["H"], c["V"]
    x = torch.randn((N, H), generator=g, device="cuda").to(dtype)
    table = (torch.randn((V, H), generator=g, device="cuda") * 0.02).to(dtype)
    t = torch.randint(0, V, (N,), generator=g, device="cuda")
    t[::4] = -100
    dl = (torch.rand((N,), generator=g, device="cuda") + 0.5) / N * (t >= 0)
    return x, table, t, dl


def _fce_bounds(fce, c, elt):
    """Least time (ms) of each kernel; bytes: x, W, int64 targets, and
    per kernel lse / tl out (forward), lse, dl in and dx out (dx), lse,
    dl in and dW out (dW)."""
    N, H, V = c["N"], c["H"], c["V"]
    x_b, w_b = N * H * elt, V * H * elt
    base = x_b + w_b + 8 * N + 8 * N
    nbytes = {"fwd": base, "dx": base + x_b, "dw": base + w_b}
    return _bounds(fce.fce_flops(N, H, V), nbytes, elt)


def _device_ms(torch, fn, names, flush, reps=3) -> dict:
    """Device ms per call of ``fn`` of the kernels whose names contain
    each of ``names`` (L2 flushed before each call)."""
    fn()
    times = _kernel_us(torch, fn, flush, reps)
    ms = {n: sum(t for k, t in times.items() if n in k) / 1e3 for n in names}
    if not all(ms.values()):
        raise AssertionError(f"the profiler saw no device time for {ms}")
    return ms


def fce_case(torch, name, over, dtype, seed, flush, timed):
    from byteps_tpu_torch.ops import fused_cross_entropy as fce

    c = {**FCE_MAIN, **over}
    dname = str(dtype).split(".")[-1]
    x, table, t, dl = _fce_inputs(torch, seed, c, dtype)
    w = table.t()                     # the tied head's [H, V] view
    valid = t >= 0
    lse, tl = fce.fce_forward(x, w, t)
    lse_r, tl_r = fce.fce_forward_reference(x, w, t)
    dx, dw = fce.fce_backward(x, w, t, lse_r, dl)
    dx_r = fce.fce_backward_dx_reference(x, w, t, lse_r, dl)
    dw_r = fce.fce_backward_dw_reference(x, w, t, lse_r, dl)
    torch.cuda.synchronize()
    outs = {"fwd": ((lse, lse_r), (torch.where(valid, lse - tl, 0.0),
                                   torch.where(valid, lse_r - tl_r, 0.0))),
            "dx": ((dx, dx_r),), "dw": ((dw, dw_r),)}
    fp32 = dtype == torch.float32
    res = {"case": name, "dtype": dname, "N_H_V": [c["N"], c["H"], c["V"]],
           "ignored_rows": int((~valid).sum().item())}
    for kname, pairs in outs.items():
        tol = (1e-5 if kname == "fwd" else 1e-4) if fp32 else 2e-2
        abs_err = rel_err = 0.0
        for out, ref in pairs:
            if not (torch.isfinite(out.float()).all()
                    and torch.isfinite(ref.float()).all()):
                raise AssertionError(f"fused CE {kname} {name} {dname}: "
                                     f"non-finite output")
            e = (out.float() - ref.float()).abs().max().item()
            abs_err = max(abs_err, e)
            rel_err = max(rel_err, e / max(ref.float().abs().max().item(),
                                           1e-30))
        if rel_err > tol:
            raise AssertionError(f"fused CE {kname} {name} {dname}: error "
                                 f"{rel_err} of the largest magnitude > {tol}")
        res.update({f"{kname}_max_abs_err": abs_err, f"{kname}_err": rel_err,
                    f"{kname}_tolerance": tol})
    if (dx[~valid] != 0).any():
        raise AssertionError("an ignored row got a gradient")
    del dx_r, dw_r
    if not timed:
        return res
    bwd = (x, w, t, lse_r, dl)
    res["fwd_ms"] = _time_ms(torch, lambda: fce.fce_forward(x, w, t), flush,
                             iters=10)
    dev = _device_ms(torch, lambda: fce.fce_backward(*bwd), FCE_KERNELS,
                     flush)
    res["dlogits_ms"] = dev["fce_dlogits_kernel"]
    res["dx_ms"] = dev["fce_dlogits_kernel"] + dev["fce_dx_kernel"]
    res["dw_ms"] = dev["fce_dw_kernel"]
    res["backward_event_ms"] = _time_ms(
        torch, lambda: fce.fce_backward(*bwd), flush, iters=3)
    res["fwd_plain_ms"] = _time_ms(
        torch, lambda: fce.fce_forward_reference(x, w, t), flush, iters=3)
    res["dx_plain_ms"] = _time_ms(
        torch, lambda: fce.fce_backward_dx_reference(*bwd), flush, iters=2)
    res["dw_plain_ms"] = _time_ms(
        torch, lambda: fce.fce_backward_dw_reference(*bwd), flush, iters=2)
    # the yardsticks: cuBLAS's GEMM of each product alone
    d = torch.randn((c["N"], c["V"]), device="cuda").to(dtype)
    res["fwd_library_ms"] = _time_ms(torch, lambda: torch.matmul(x, w),
                                     flush, iters=5)
    res["dx_library_ms"] = _time_ms(torch, lambda: torch.matmul(d, table),
                                    flush, iters=5)
    res["dw_library_ms"] = _time_ms(torch, lambda: torch.matmul(d.t(), x),
                                    flush, iters=5)
    del d
    for kname, (b, by) in _fce_bounds(fce, c, x.element_size()).items():
        res[f"{kname}_bound_ms"], res[f"{kname}_bound_by"] = b, by
    return res


def fce_kernel_phase(torch, seed: int):
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, over in FCE_CASES:
            timed = not over and dtype == torch.bfloat16
            r = fce_case(torch, name, over, dtype, seed, flush, timed)
            _line(r)
            if timed:
                main = r
            torch.cuda.empty_cache()
    return main

# ------------------------------------------------------------ generation


def _gen_counts() -> dict:
    from byteps_tpu_torch.ops import decode_attention as da
    from byteps_tpu_torch.ops import flash_attention as fa
    from byteps_tpu_torch.ops import quant_dot as qd

    return {"flash_fwd": fa.fwd_launches, "decode": da.launches,
            "quant_dot": qd.launches,
            "plain": fa.plain_calls + da.plain_calls + qd.plain_calls}


def generate_reference_phase(torch, seed: int) -> dict:
    """fp32: flat (kernel) vs grouped (plain) caches, fp and int8; int8
    weights vs the same weights dequantized; seeded sampling repeats."""
    import copy

    import numpy as np

    from byteps_tpu_torch.inference import (classify_divergence, generate,
                                            quantize_params)
    from byteps_tpu_torch.models.transformer import (Dense, Transformer,
                                                     TransformerConfig,
                                                     init_cache, init_weights)

    cfg = TransformerConfig(**{**LLAMA_3_2_1B, **TRAIN_REF},
                            attn_impl="flash", dtype=torch.float32)
    model = Transformer(cfg, device="cuda")
    init_weights(model, seed)
    B, T, n, L = 2, 128, 32, cfg.num_layers
    prompt = np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                                 size=(B, T))
    info = {"phase": "generate_reference", "prompt": [B, T],
            "new_tokens": n}

    def run(m, want, **kw):
        _zero_counts()
        out = generate(m, prompt, n, temperature=0, **kw)
        torch.cuda.synchronize()
        counts = _gen_counts()
        if counts != want:
            raise AssertionError(f"generate {kw}: launches {counts}, want "
                                 f"{want}")
        return out["tokens"].cpu().numpy()

    flat_want = {"flash_fwd": L, "decode": (n - 1) * L, "quant_dot": 0,
                 "plain": 0}
    for kv_quant in (False, True):
        tag = "int8_cache_" if kv_quant else ""
        flat = run(model, flat_want, cache_layout="flat", kv_quant=kv_quant)
        grouped = run(model, {**flat_want, "decode": 0},
                      cache_layout="grouped", kv_quant=kv_quant)
        if not (flat == grouped).all():
            raise AssertionError(f"{tag}flat (kernel) tokens {flat} != "
                                 f"grouped {grouped}")
        info[f"{tag}flat_vs_grouped_identical"] = True
    # int8 weights against the same int8 weights dequantized to fp32
    quantize_params(model)
    deq = copy.deepcopy(model)
    for m in deq.modules():
        if isinstance(m, Dense):
            m.weight = torch.nn.Parameter(m.weight.float() * m.scale[:, None],
                                          requires_grad=False)
            m.scale = None

    def prefill(m):
        caches = init_cache(cfg, B, T, layout="flat", device="cuda")
        return m.decode(torch.from_numpy(prompt).cuda(), caches, 0)[0]

    _zero_counts()
    lq = prefill(model)
    if _gen_counts()["quant_dot"] != 7 * L:
        raise AssertionError(f"int8 prefill launches {_gen_counts()}")
    lf = prefill(deq)
    logit_rel = ((lq - lf).abs().max() / lf.abs().max()).item()
    if not torch.isfinite(lq).all() or logit_rel > 1e-4:
        raise AssertionError(f"int8 vs dequantized prefill logits differ by "
                             f"{logit_rel} of the largest")
    tq = run(model, {**flat_want, "quant_dot": n * 7 * L},
             cache_layout="flat")
    tf = run(deq, flat_want, cache_layout="flat")
    verdict = classify_divergence(deq, prompt, tf, tq)
    if verdict["divergence"] == "real":
        raise AssertionError(f"int8 weights vs dequantized: {verdict}")
    sampled = [generate(deq, prompt, n, temperature=0.8, top_k=50, top_p=0.95,
                        seed=seed + 1)["tokens"].cpu().numpy()
               for _ in range(2)]
    if not (sampled[0] == sampled[1]).all():
        raise AssertionError("seeded sampled generation did not repeat")
    info.update({"int8_weights_logit_rel_diff": logit_rel,
                 "int8_weights_vs_dequantized": verdict["divergence"],
                 "int8_weights_agreement": verdict["agreement"],
                 "sampled_rerun_identical": True,
                 "sampled_differs_from_greedy": bool((sampled[0] != tf).any())})
    del model, deq
    torch.cuda.empty_cache()
    return info


def _decode_profile(torch, model, prompt, steps=8, **cache_kw) -> dict:
    """``steps`` decode steps of ``Transformer.decode`` (the call the
    generate loop makes) after a prefill, under ``torch.profiler``: CUDA
    kernels and device busy ms per step, host wall per step (with the
    profiler on), the device's idle share, and the kernels taking the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from byteps_tpu_torch.models.transformer import init_cache

    B, T = prompt.shape
    caches = init_cache(model.cfg, B, T + steps, device="cuda", **cache_kw)
    logits, _ = model.decode(prompt, caches, 0, last_only=True)
    tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, _ = model.decode(tok[:, None], caches, T + i)
            tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, n, busy_us = {}, 0, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n += 1
            busy_us += us
            by_name[e.name[:70]] = by_name.get(e.name[:70], 0.0) + us
    if not n:
        raise AssertionError("the profiler saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": steps, "kernels_per_step": n / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "host_ms_per_step_profiled": wall_ms / steps,
            "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "top_device_ms_per_step": {k: v / 1e3 / steps for k, v in top}}


def generate_phase(torch, seed: int):
    """Full-width Llama-3.2-1B cached generation through
    ``make_generate_fn``: fp flat (twice), grouped, int8-cache flat
    (twice), int8 weights (twice).  Returns the run lines and the launch
    counts of the last fp, int8-cache and int8-weight runs."""
    import numpy as np

    from byteps_tpu_torch.inference import (classify_divergence,
                                            make_generate_fn, quantize_params)
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=MAX_SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    L, steps = cfg.num_layers, GEN_NEW - 1
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompt = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(GEN_B, GEN_PROMPT))).cuda()
    fp_want = {"flash_fwd": L, "decode": steps * L, "quant_dot": 0,
               "plain": 0}

    def run(name, want, **kw):
        fn = make_generate_fn(model, GEN_NEW, temperature=0, **kw)
        events = []

        def on_step(i):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        t1 = time.perf_counter()
        out = fn(prompt, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = _gen_counts()
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, want {want}")
        if not out["tokens"].is_cuda:
            raise AssertionError(f"{name}: tokens are not on the GPU")
        toks = out["tokens"].cpu().numpy()
        if toks.shape != (GEN_B, GEN_NEW) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{name}: bad tokens {toks.shape}")
        dec = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        line = {"phase": "generate_run", "run": name, "layout":
                kw.get("cache_layout", "auto"),
                "kv_quant": kw.get("kv_quant", False),
                "prefill_ms": start.elapsed_time(events[0]),
                "decode_ms_p50": float(np.median(dec)),
                "decode_ms_max": float(np.max(dec)), "wall_s": wall,
                "tokens_per_s": GEN_B * GEN_NEW / wall,
                "decode_tokens_per_s": GEN_B / (float(np.median(dec)) / 1e3),
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": counts, "nvidia_smi": _smi()}
        _line(line)
        return toks, line

    runs = {}
    for name, want, kw in (
            ("fp_flat", fp_want, {}),
            ("fp_flat_rerun", fp_want, {}),
            ("fp_grouped", {**fp_want, "decode": 0},
             {"cache_layout": "grouped"}),
            ("int8_cache", fp_want, {"kv_quant": True,
                                     "cache_layout": "flat"}),
            ("int8_cache_rerun", fp_want, {"kv_quant": True,
                                           "cache_layout": "flat"})):
        runs[name] = run(name, want, **kw)
    verdict = classify_divergence(model, prompt, runs["fp_flat"][0],
                                  runs["fp_grouped"][0])
    if verdict["divergence"] == "real":
        raise AssertionError(f"flat (kernel) vs grouped: {verdict}")
    int8_cache_vs_fp = classify_divergence(model, prompt, runs["fp_flat"][0],
                                           runs["int8_cache"][0])
    profiles = {"fp_flat": _decode_profile(torch, model, prompt,
                                           layout="flat")}
    quantize_params(model)
    q_want = {**fp_want, "quant_dot": GEN_NEW * 7 * L}
    for name in ("int8_weights", "int8_weights_rerun"):
        runs[name] = run(name, q_want, cache_layout="flat")
    profiles["int8_weights"] = _decode_profile(torch, model, prompt,
                                               layout="flat")
    for a in ("fp_flat", "int8_cache", "int8_weights"):
        if not (runs[a][0] == runs[a + "_rerun"][0]).all():
            raise AssertionError(f"{a}: greedy rerun is not token-identical")
    info = {"phase": "generate", "model": "Llama-3.2-1B (random weights)",
            "source": "meta-llama/Llama-3.2-1B config.json",
            "reduced": {"max_seq": [131072, MAX_SEQ]},
            "dtype": "bfloat16", "batch": GEN_B, "prompt": GEN_PROMPT,
            "new_tokens": GEN_NEW, "setup_s": setup_s,
            "reruns_identical": True,
            "flat_vs_grouped": verdict,
            "int8_cache_vs_fp": int8_cache_vs_fp,
            "decode_step_profile": profiles,
            "runs": {n: {k: v for k, v in r[1].items()
                         if k not in ("phase", "run")}
                     for n, r in runs.items()}}
    launches = {n: runs[n][1]["launches"] for n in
                ("fp_flat_rerun", "int8_cache_rerun", "int8_weights_rerun")}
    del model
    torch.cuda.empty_cache()
    return info, launches


# ------------------------------------------------------ decode attention

DECODE_MAIN = dict(B=GEN_B, S=MAX_SEQ, H=32, KV=8, D=64, pos=MAX_SEQ - 1,
                   window=None)
DECODE_CASES = (("pos_2047", {}), ("pos_0", {"pos": 0}),
                ("pos_1000", {"pos": 1000}), ("window256", {"window": 256}),
                ("s2000_ragged", {"S": 2000, "pos": 1999}),
                ("mha_head_dim32", {"KV": 32, "D": 32}),
                ("head_dim128", {"D": 128}), ("mqa", {"KV": 1}))


def _decode_inputs(torch, seed, c, mode):
    """q [B, 1, H, D] and flat caches: fp32 or bf16, or int8 values and
    scales (``_quantize_kv``) with a bf16 q."""
    from byteps_tpu_torch.models.transformer import _quantize_kv

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    B, S, H, KV, D = c["B"], c["S"], c["H"], c["KV"], c["D"]
    q = torch.randn((B, 1, H, D), generator=g, device="cuda")
    k = torch.randn((B, S, KV, D), generator=g, device="cuda")
    v = torch.randn((B, S, KV, D), generator=g, device="cuda")
    if mode == "int8":
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        return (q.to(torch.bfloat16), kq.reshape(B, S, -1),
                vq.reshape(B, S, -1), ks, vs)
    dt = torch.float32 if mode == "float32" else torch.bfloat16
    return (q.to(dt), k.reshape(B, S, -1).to(dt), v.reshape(B, S, -1).to(dt),
            None, None)


def decode_case(torch, name, over, mode, seed, flush, timed):
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import decode_attention as da

    c = {**DECODE_MAIN, **over}
    B, S, H, KV, D, pos, w = (c[k] for k in ("B", "S", "H", "KV", "D",
                                             "pos", "window"))
    q, ck, cv, ks, vs = _decode_inputs(torch, seed, c, mode)
    args = (q, ck, cv, pos)
    kw = {"k_scale": ks, "v_scale": vs, "window": w}
    out = da.decode_attention(*args, **kw)
    ref = da.decode_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(out.float()).all()
            and torch.isfinite(ref.float()).all()):
        raise AssertionError(f"decode {name} {mode}: non-finite output")
    abs_err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    tol = 1e-4 if mode == "float32" else 2e-2
    err = abs_err if mode == "float32" else abs_err / top
    if err > tol:
        raise AssertionError(f"decode {name} {mode}: error {err} > {tol}")
    res = {"case": name, "mode": mode, "B_S_H_KV_D": [B, S, H, KV, D],
           "pos": pos, "window": w, "max_abs_err": abs_err, "err": err,
           "tolerance": tol}
    if not timed:
        return res
    res["kernel_ms"] = _graph_ms(torch, lambda: da.decode_attention(
        *args, **kw), flush)
    res["plain_ms"] = _graph_ms(
        torch, lambda: da.decode_attention_reference(*args, **kw), flush,
        iters=5)
    # the yardstick: SDPA over the attended rows (int8: dequantized to bf16)
    n = pos + 1
    kd, vd = (x.view(B, S, KV, D)[:, :n] for x in (ck, cv))
    if mode == "int8":
        kd = (kd.float() * ks[:, :n, :, None]).to(torch.bfloat16)
        vd = (vd.float() * vs[:, :n, :, None]).to(torch.bfloat16)
    kd, vd = (x.transpose(1, 2).contiguous() for x in (kd, vd))
    qd = q.transpose(1, 2).contiguous()
    lib = F.scaled_dot_product_attention(qd, kd, vd, enable_gqa=True)
    res["library_err"] = (lib.transpose(1, 2).float()
                          - ref.float()).abs().max().item()
    res["library_ms"] = _graph_ms(
        torch, lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                      enable_gqa=True),
        flush)
    elt = ck.element_size()
    nbytes = (da.kv_bytes_read(B, pos, KV * D, elt, w,
                               kv_heads=KV if mode == "int8" else 0)
              + 2 * q.numel() * q.element_size())           # q in, out
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (da.decode_flops(B, H, D, pos, w)
             / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3)
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    res["bytes"] = nbytes
    return res


def decode_kernel_phase(torch, seed: int) -> dict:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    main = {}
    for mode in ("bfloat16", "int8", "float32"):
        for name, over in DECODE_CASES:
            timed = not over and mode != "float32"
            r = decode_case(torch, name, over, mode, seed, flush, timed)
            _line(r)
            if timed:
                main[mode] = r
        torch.cuda.empty_cache()
    return main


# ------------------------------------------------------ int8 product

# Llama-3.2-1B's projections (K -> N) and how many a layer runs
QUANT_SHAPES = (("q_o_2048x2048", 2048, 2048, 2),
                ("k_v_2048x512", 2048, 512, 2),
                ("gate_up_2048x8192", 2048, 8192, 2),
                ("down_8192x2048", 8192, 2048, 1))
QUANT_ROWS = (GEN_B, GEN_B * GEN_PROMPT)   # decode, prefill


def quant_case(torch, name, M, K, N, dtype, bias, seed, flush, timed):
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import quant_dot as qd

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w, scale = qd.quantize_weight(
        torch.randn((N, K), generator=g, device="cuda") * 0.02)
    b = torch.randn((N,), generator=g, device="cuda") if bias else None
    out = qd.quant_linear(x, w, scale, b)
    ref = qd.quant_linear_reference(x, w, scale, b)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"quant {name} M={M}: non-finite output")
    top = ref.float().abs().max().item()
    abs_err = (out.float() - ref.float()).abs().max().item()
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5)
    if abs_err > tol * top:
        raise AssertionError(f"quant {name} M={M} {dtype} bias={bias}: "
                             f"error {abs_err} > {tol} x {top}")
    res = {"case": name, "M_K_N": [M, K, N],
           "dtype": str(dtype).split(".")[-1], "bias": bias,
           "max_abs_err": abs_err, "err": abs_err / top,
           "err_bf16_ulps_of_max": abs_err / (2.0 ** -7 * top),
           "tolerance": tol}
    if not timed:
        return res
    iters = 20 if M <= 64 else 3
    res["kernel_ms"] = _graph_ms(
        torch, lambda: qd.quant_linear(x, w, scale), flush, iters)
    res["plain_ms"] = _graph_ms(
        torch, lambda: qd.quant_linear_reference(x, w, scale), flush,
        min(iters, 5))
    wbf = (w.float() * scale[:, None]).to(torch.bfloat16)
    res["library_ms"] = _graph_ms(torch, lambda: F.linear(x, wbf), flush,
                                  iters)
    elt = x.element_size()
    nbytes = M * K * elt + N * K + 4 * N + M * N * elt
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = qd.quant_flops(M, N, K) / PEAK_FLOPS["bfloat16"] * 1e3
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return res


def quant_kernel_phase(torch, seed: int) -> dict:
    """Every case checked; bf16 without bias timed.  Returns the sums of
    one layer's seven decode (M=8) projections."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    layer = {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
             "bound_ms": 0.0, "max_abs_err": 0.0, "bytes_bound": True}
    cases = [(n, M, K, N, c) for M in QUANT_ROWS
             for n, K, N, c in QUANT_SHAPES]
    cases.append(("probe_768x3072", 8, 768, 3072, 0))
    for name, M, K, N, count in cases:
        for dtype in (torch.bfloat16, torch.float32):
            for bias in (False, True):
                timed = dtype == torch.bfloat16 and not bias
                r = quant_case(torch, name, M, K, N, dtype, bias, seed, flush,
                               timed)
                _line(r)
                if timed and M == GEN_B and count:
                    for k in ("kernel_ms", "plain_ms", "library_ms",
                              "bound_ms"):
                        layer[k] += count * r[k]
                    layer["max_abs_err"] = max(layer["max_abs_err"],
                                               r["max_abs_err"])
                    layer["bytes_bound"] &= r["bound_by"] == "bytes"
        torch.cuda.empty_cache()
    layer["bound_by"] = "bytes" if layer.pop("bytes_bound") else "operations"
    _line({"phase": "quant_dot_decode_layer", **layer})
    return layer


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs a GPU",
              file=sys.stderr)
        return 1
    from byteps_tpu_torch.ops import _build

    # fp32 products in full fp32 for the reference phases (TF32 keeps
    # three digits); stated and set, not assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    _line({"phase": "device", "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    libs = _build.build(KERNEL_SOURCES)   # one nvcc per source, in parallel
    _line({"phase": "build", "kernels": {n: str(p) for n, p in libs.items()},
           "seconds": time.perf_counter() - t0,
           "ptxas": {n: [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln]
                     for n, log in _build.build_logs.items()}})
    _line(ptxas_phase(_build.build_logs))
    _line(reference_phase(torch, args.seed))
    serve_info, paged_launches, final_pos = serve_phase(torch, args.seed)
    serve_info["nvidia_smi"] = smi
    _line(serve_info)
    _, paged_main = kernel_phase(torch, args.seed, final_pos)
    _line(serve_role_phase(torch))
    _line(serve_role_phase(torch, TIERS_ROLE_ENV))
    _line(tiers_reference_phase(torch, args.seed))
    tiers_info, tiers_tp1, tiers_tp2 = tiers_serve_phase(torch, args.seed)
    tiers_info["nvidia_smi"] = _smi()
    _line(tiers_info)
    tiers_main = tiers_kernel_phase(torch, args.seed, tiers_tp1["final_pos"])
    _line(train_reference_phase(torch, args.seed))
    train_info, flash_launches, _ = train_phase(torch, args.seed)
    train_info["nvidia_smi"] = _smi()
    _line(train_info)
    flash_main = flash_kernel_phase(torch, args.seed)
    _line(fused_reference_phase(torch, args.seed))
    fused_info, fce_launches, eval_info = train_phase(
        torch, args.seed, fused_head=True,
        then=lambda tr, m: eval_phase(torch, args.seed, tr, m))
    warm_rel = (abs(fused_info["losses"][0] - train_info["losses"][0])
                / abs(train_info["losses"][0]))
    if warm_rel > EVAL_TOL:
        raise AssertionError(f"fused-head warm-up loss "
                             f"{fused_info['losses'][0]} vs plain head "
                             f"{train_info['losses'][0]}: {warm_rel}")
    fused_info["warmup_loss_rel_diff_vs_plain_head"] = warm_rel
    fused_info["nvidia_smi"] = _smi()
    _line(fused_info)
    _line(eval_info)
    fce_main = fce_kernel_phase(torch, args.seed)
    _line(generate_reference_phase(torch, args.seed))
    gen_info, gen_launches = generate_phase(torch, args.seed)
    _line(gen_info)
    decode_main = decode_kernel_phase(torch, args.seed)
    quant_layer = quant_kernel_phase(torch, args.seed)
    print(_smi(), flush=True)
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "byteps_tpu_torch/csrc/paged_attention.cu",
        "replaces": "byteps_tpu/ops/paged_attention.py:76",
        "launches": paged_launches, "max_abs_err": paged_main["max_err"],
        "ms": paged_main["kernel_ms"], "plain_ms": paged_main["plain_ms"],
        "bound_ms": paged_main["bound_ms"],
        "bound_by": paged_main["bound_by"],
        "library_ms": paged_main["library_ms"]}]
    for kname, run, ms, err in (
            ("paged_attention_int8", tiers_tp1, "kernel_ms", "max_err"),
            ("paged_attention_int8_tp2", tiers_tp2, "tp2_ms", "tp2_max_err")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "byteps_tpu_torch/csrc/paged_attention.cu",
            "replaces": ("byteps_tpu/ops/paged_attention.py:76"
                         if run["tp"] == 1 else
                         "byteps_tpu/ops/paged_attention.py:306"),
            "launches": run["launches"], "max_abs_err": tiers_main[err],
            "ms": tiers_main[ms], "plain_ms": tiers_main["plain_ms"],
            "bound_ms": tiers_main["bound_ms"],
            "bound_by": tiers_main["bound_by"],
            "library_ms": tiers_main["library_ms"]})
    for kname, line, n in (("fwd", 116, flash_launches[0]),
                           ("dq", 374, flash_launches[1]),
                           ("dkv", 444, flash_launches[2])):
        kernels.append({
            "name": f"flash_attention_{kname}", "route": "cuda",
            "source": "byteps_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"byteps_tpu/ops/flash_attention.py:{line}",
            "launches": n,
            "max_abs_err": flash_main[f"{kname}_max_abs_err"],
            "ms": flash_main[f"{kname}_ms"],
            "plain_ms": flash_main[f"{kname}_plain_ms"],
            "bound_ms": flash_main[f"{kname}_bound_ms"],
            "bound_by": flash_main[f"{kname}_bound_by"],
            # SDPA's backward computes dq, dk and dv in one call
            "library_ms": flash_main["library_fwd_ms" if kname == "fwd"
                                     else "library_bwd_ms"]})
    for kname, line, n in (("fwd", 77, fce_launches[3]),
                           ("dx", 115, fce_launches[4]),
                           ("dw", 144, fce_launches[5])):
        kernels.append({
            "name": f"fused_cross_entropy_{kname}", "route": "cuda",
            "source": "byteps_tpu_torch/csrc/fused_cross_entropy.cu",
            "replaces": f"byteps_tpu/ops/fused_cross_entropy.py:{line}",
            "launches": n, "max_abs_err": fce_main[f"{kname}_max_abs_err"],
            "ms": fce_main[f"{kname}_ms"],
            "plain_ms": fce_main[f"{kname}_plain_ms"],
            "bound_ms": fce_main[f"{kname}_bound_ms"],
            "bound_by": fce_main[f"{kname}_bound_by"],
            "library_ms": fce_main[f"{kname}_library_ms"]})
    for kname, mode, run in (("decode_attention", "bfloat16", "fp_flat_rerun"),
                             ("decode_attention_int8", "int8",
                              "int8_cache_rerun")):
        r = decode_main[mode]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "byteps_tpu_torch/csrc/decode_attention.cu",
            "replaces": "byteps_tpu/ops/decode_attention.py:71",
            "launches": gen_launches[run]["decode"],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    kernels.append({
        "name": "quant_dot", "route": "cuda",
        "source": "byteps_tpu_torch/csrc/quant_dot.cu",
        "replaces": "scripts/dot_probe.py:27",
        "launches": gen_launches["int8_weights_rerun"]["quant_dot"],
        "max_abs_err": quant_layer["max_abs_err"],
        "ms": quant_layer["kernel_ms"], "plain_ms": quant_layer["plain_ms"],
        "bound_ms": quant_layer["bound_ms"],
        "bound_by": quant_layer["bound_by"],
        "library_ms": quant_layer["library_ms"]})
    _line({"kernels": kernels})
    _line({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
