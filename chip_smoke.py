#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``byteps_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises (non-zero exit, no result line) on failure:

1. Device — the ``nvidia-smi`` name / power-limit line, torch and CUDA
   versions.  Exits 1 at once when ``torch.cuda.is_available()`` is
   false.
2. Build — compiles every kernel of the serving path from the sources in
   the checkout (``nvcc``, ``sm_90a``) and prints the build seconds.
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
   tq=1 and tq=4, window 256, fp32 and bf16, plus the cursors of the
   serve run's last decode tick.  Max abs error <= 1e-4 in fp32 (online
   vs dense softmax order) and <= 2e-2 in bf16 (p is rounded to bf16
   before the PV product, so one bf16 ulp of a probability reaches the
   output).  Times: the kernel, the plain version, and
   ``F.scaled_dot_product_attention(enable_gqa=True)`` over pre-gathered
   dense rows as a yardstick (never called by the port), with the L2
   cache flushed before every timed launch; the bound is the bytes the
   kernel must move over 3.35 TB/s (or its FLOPs over the dtype's peak
   if larger).

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


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _line(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    model = Transformer(cfg, device="cuda")
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


def _kernel_case(torch, np, seed, pos, tq, dtype):
    H, KV, D = 32, 8, 64
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
    return (q.to(dtype), ck.to(dtype), cv.to(dtype),
            torch.from_numpy(table).cuda(),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


def _time_ms(torch, fn, flush, iters=20) -> float:
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


def _bound(pa, q, pos, tq, window, elt, dtype_name):
    B, _, H, D = q.shape
    KVD = 8 * D
    nbytes = (pa.kv_bytes_read(pos, tq, BLOCK, KVD, elt, window)
              + 2 * q.numel() * elt                      # q in, out
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
                                 else "operations")


def kernel_case(torch, np, name, pos, tq, window, dtype, seed, flush):
    import torch.nn.functional as F

    from byteps_tpu_torch.ops import paged_attention as pa

    dname = str(dtype).split(".")[-1]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q, ck, cv, table, posv = _kernel_case(torch, np, seed, pos, tq, dtype)
    out = pa.paged_attention(q, ck, cv, table, posv, window=window)
    ref = pa.paged_attention_reference(q, ck, cv, table, posv,
                                       window=window)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.isfinite(out.float()).all() or err > tol:
        raise AssertionError(f"{name} {dname}: max abs err {err} > {tol}")
    # the yardstick: SDPA over the same keys gathered into dense rows
    B, _, H, D = q.shape
    nb = -(-(max(pos) + tq) // BLOCK)
    S = nb * BLOCK
    idx = table[:, :nb].long()
    kd = ck[idx].reshape(B, S, 8, D).transpose(1, 2).contiguous()
    vd = cv[idx].reshape(B, S, 8, D).transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    c = torch.arange(S, device="cuda")
    qpos = posv.long()[:, None] + torch.arange(tq, device="cuda")[None]
    mask = c[None, None, :] <= qpos[:, :, None]
    if window:
        mask = mask & (c[None, None, :] > qpos[:, :, None] - window)
    mask = mask[:, None]                                 # [B, 1, tq, S]
    lib = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                         enable_gqa=True)
    lib_err = (lib.transpose(1, 2).float() - ref.float()).abs().max().item()
    kernel_ms = _time_ms(torch, lambda: pa.paged_attention(
        q, ck, cv, table, posv, window=window), flush)
    plain_ms = _time_ms(torch, lambda: pa.paged_attention_reference(
        q, ck, cv, table, posv, window=window), flush)
    library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), flush)
    bound_ms, bound_by = _bound(pa, q, pos, tq, window,
                                q.element_size(), dname)
    return {"case": name, "dtype": dname, "tq": tq, "window": window,
            "max_err": err, "tolerance": tol, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_err": lib_err, "bound_ms": bound_ms,
            "bound_by": bound_by}


def kernel_phase(torch, seed: int, final_pos):
    import numpy as np

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.RandomState(seed)
    ragged = sorted(int(x) for x in rng.randint(1, 2048, size=N_SLOTS - 2))
    ragged = [1] + ragged + [2047]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, pos, tq, window in (
                ("ragged_1_2047", ragged, 1, None),
                ("all_at_2047", [2047] * N_SLOTS, 1, None),
                ("ragged_tq4", [min(p, 2044) for p in ragged], 4, None),
                ("all_at_2044_tq4", [2044] * N_SLOTS, 4, None),
                ("ragged_window256", ragged, 1, 256),
                ("ragged_tq4_window256", [min(p, 2044) for p in ragged],
                 4, 256)):
            cases.append(kernel_case(torch, np, name, pos, tq, window,
                                     dtype, seed, flush))
            _line(cases[-1])
    main = kernel_case(torch, np, "serve_last_tick", final_pos, 1, None,
                       torch.bfloat16, seed, flush)
    _line(main)
    return cases, main


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
    from byteps_tpu_torch.ops import paged_attention as pa

    # fp32 products in full fp32 for the reference phase (TF32 keeps
    # three digits); stated and set, not assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    _line({"phase": "device", "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    so = pa.build()
    _line({"phase": "build", "kernels": {"paged_attention": str(so)},
           "seconds": time.perf_counter() - t0,
           "ptxas": [ln.strip() for ln in pa.build_log.splitlines()
                     if "registers" in ln or "smem" in ln]})
    _line(reference_phase(torch, args.seed))
    serve_info, launches, final_pos = serve_phase(torch, args.seed)
    serve_info["nvidia_smi"] = smi
    _line(serve_info)
    _, main_case = kernel_phase(torch, args.seed, final_pos)
    print(_smi(), flush=True)
    _line({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "byteps_tpu_torch/csrc/paged_attention.cu",
        "replaces": "byteps_tpu/ops/paged_attention.py:76",
        "launches": launches, "max_abs_err": main_case["max_err"],
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]})
    _line({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
