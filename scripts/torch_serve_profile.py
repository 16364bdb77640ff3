#!/usr/bin/env python3
"""Where a decode tick of the port's serving engine spends its time on the
GPU (byteps_tpu_torch, Llama-3.2-1B at full width, bf16, random weights).

    python3 scripts/torch_serve_profile.py [--ticks 20] [--seed 0]
        [--kv-dtype int8] [--tp 2] [--spec-k 4] [--prefix]
        [--paged-kernel off]
    python3 scripts/torch_serve_profile.py --dense flat|grouped
        [--ticks 20] [--seed 0] [--prefix] [--spec-k 4 (grouped)]

Admits 8 requests (prompts of 32-512 tokens, as ``chip_smoke.py``;
with ``--prefix`` each behind a shared 256-token prefix, and the engine
keeps a prefix store, so admissions after the first hit it) straight
into a ``ServingEngine`` (no TCP tier; the paged engine with an fp pool
at tp=1 on the paged kernel without speculation unless asked, or with
``--paged-kernel off`` the gather fallback; ``--dense`` the dense slot
engine on flat rows, whose tick is one decode-kernel launch a layer at a
position vector, or grouped rows, which alone take ``--spec-k``: one
``verify_tokens`` pass a tick; the paged engine's ``--kv-dtype``,
``--tp`` and ``--paged-kernel`` are refused with it), steps until every
one is decoding, then measures steady decode (or, with ``--spec-k``,
verify) ticks three ways:

* host wall time per tick (``engine.step()`` ending in the token
  read-back, which synchronizes);
* ``torch.profiler`` over the same number of ticks: device time per
  kernel name, kernel launches per tick, and the device's busy share of
  the wall (union of kernel intervals / profiled wall);
* host time per tick split by layer: the seconds spent inside the
  engine's step, the model's tick, each layer's attention (its q/k/v
  projections, its attention call: the decode or paged kernel's wrapper
  or plain attention) and MLP, the linear layers and the head, and on
  the gather fallback the gather pass (rows gathered, decoded and
  scattered back) and the row gather alone, timed on the host's clock
  around each call over the same number of ticks (inclusive: a part
  holds the parts it calls).

Prints one JSON line per measurement, the first with the card's name
and power limit; ``--out`` also writes them all to a file.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LLAMA_3_2_1B = dict(
    vocab_size=128256, num_layers=16, num_heads=32, num_kv_heads=8,
    d_model=2048, d_ff=8192, head_dim=64, norm="rmsnorm", norm_eps=1e-5,
    pos_emb="rope", rope_theta=500000.0, mlp="swiglu", tie_embeddings=True,
    rope_scaling=(("factor", 32.0), ("high_freq_factor", 4.0),
                  ("low_freq_factor", 1.0),
                  ("original_max_position_embeddings", 8192),
                  ("rope_type", "llama3")))
PROMPT_LENS = (32, 96, 160, 224, 288, 352, 416, 512)


def _busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _host_split(eng, ticks: int) -> dict:
    """Host milliseconds a tick inside each part of the tick (inclusive),
    timed around every call over ``ticks`` steady ticks; the timers are
    removed afterwards."""
    import torch

    from byteps_tpu_torch.models import transformer as tm

    parts = {"engine_step": (type(eng), "step"),
             "model_tick": (tm.Transformer, "decode"),
             "model_tick_paged": (tm.Transformer, "decode_paged_fused"),
             "gather_step": (type(eng), "_gather_step"),
             "gather_rows": (tm, "gather_paged_rows"),
             "attention_layer": (tm.Attention, "forward_cached"),
             "attention_layer_paged": (tm.Attention, "forward_paged"),
             "qkv_rope": (tm.Attention, "_qkv"),
             "decode_kernel_wrapper": (tm, "decode_attention"),
             "paged_kernel_wrapper": (tm, "paged_attention"),
             "plain_attention": (tm, "_cached_attention"),
             "mlp": (tm.MLP, "forward"),
             "linear": (tm.Dense, "forward"),
             "head": (tm.Transformer, "_head")}
    spent = dict.fromkeys(parts, 0.0)
    saved = []

    def timer(key, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
        return timed

    for key, (owner, name) in parts.items():
        fn = owner.__dict__[name] if isinstance(owner, type) else getattr(
            owner, name)
        saved.append((owner, name, fn))
        setattr(owner, name, timer(key, fn))
    try:
        torch.cuda.synchronize()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return {k: v / ticks * 1e3 for k, v in spent.items() if v}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--kv-dtype", default="", choices=("", "int8"))
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--prefix", action="store_true")
    ap.add_argument("--paged-kernel", default="auto",
                    choices=("auto", "on", "off"))
    ap.add_argument("--dense", default="", choices=("", "flat", "grouped"))
    args = ap.parse_args()
    if args.dense and (args.kv_dtype or args.tp != 1
                       or args.paged_kernel != "auto"):
        ap.error("--kv-dtype, --tp and --paged-kernel are the paged "
                 "engine's; the dense engine takes none of them")
    if args.dense == "flat" and args.spec_k:
        ap.error("--spec-k needs grouped rows (--dense grouped): flat rows "
                 "decode through the kernel while the verify runs dense")
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.serving import (RequestState, ServeMetrics,
                                          ServingEngine)

    rows = []

    def emit(obj):
        rows.append(obj)
        print(json.dumps(obj), flush=True)

    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=2048,
                            dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, args.seed)
    if args.dense:
        eng = ServingEngine(model, n_slots=8, max_seq=2048,
                            cache_layout=args.dense, spec_k=args.spec_k,
                            prefix_cache=args.prefix, device="cuda",
                            metrics=ServeMetrics())
    else:
        eng = ServingEngine(model, n_slots=8, max_seq=2048, paged=True,
                            block=16, kv_dtype=args.kv_dtype, tp=args.tp,
                            spec_k=args.spec_k, prefix_cache=args.prefix,
                            paged_kernel=args.paged_kernel, device="cuda",
                            metrics=ServeMetrics())
    knobs = {"spec_k": args.spec_k, "prefix": args.prefix}
    if not args.dense:
        knobs.update(kv_dtype=args.kv_dtype or "model", tp=args.tp,
                     paged_kernel=args.paged_kernel)
    emit({"measure": "config", "engine": ("dense " + args.dense
                                          if args.dense else "paged"),
          **knobs, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": subprocess.run(
              ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"], capture_output=True,
              text=True).stdout.strip()})
    rng = np.random.RandomState(args.seed)
    budget = 3 * args.ticks + 8
    shared = rng.randint(0, cfg.vocab_size, size=(256 if args.prefix
                                                   else 0,))
    reqs = [eng.submit(np.concatenate(
        [shared, rng.randint(0, cfg.vocab_size, size=(n,))]), budget)
        for n in PROMPT_LENS]
    while not all(r.state is RequestState.ACTIVE for r in reqs):
        eng.step()
    for _ in range(3):  # warm the steady tick
        eng.step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.ticks):
        t0 = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    emit({"measure": "tick_wall_ms", "ticks": args.ticks,
          "mean": float(np.mean(walls)), "p50": float(np.median(walls)),
          "min": float(np.min(walls)), "max": float(np.max(walls))})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            eng.step()
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    emit({"measure": "profile", "ticks": args.ticks,
          "wall_ms_per_tick": prof_wall_us / args.ticks / 1e3,
          "device_busy_ms_per_tick": busy / args.ticks / 1e3,
          "device_idle_share": 1.0 - busy / prof_wall_us,
          "kernel_launches_per_tick": len(kernels) / args.ticks})
    for name, (n, t) in top:
        emit({"measure": "kernel", "name": name[:90],
              "launches_per_tick": n / args.ticks,
              "device_ms_per_tick": t / args.ticks / 1e3})
    emit({"measure": "host_split", "ticks": args.ticks,
          "ms_per_tick": _host_split(eng, args.ticks)})
    emit({"measure": "step_counts", **eng.step_counts()})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    for r in reqs:
        eng.cancel(r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
