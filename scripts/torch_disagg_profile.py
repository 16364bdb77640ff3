#!/usr/bin/env python3
"""Where a disaggregated KV ship's time goes on the GPU (byteps_tpu_torch,
Llama-3.2-1B at full width, bf16, random weights).

    python3 scripts/torch_disagg_profile.py [--seed 0] [--reps 2]

Runs ``chip_smoke.py``'s phase-6i pair (``_disagg_run``: a prefill and a
decode replica, two paged engines with bf16 pools of 1025 blocks behind
two ``ServeFrontend``s in this one process) on phase 4's 8 prompts
(32-512 tokens, 32 new each): ``--reps`` times with all 8 requests at
once, then each prompt alone.  Every run prints the phase's line (ship
p50 / p99, MB/s, TTFT with the ship, the decode replica's TPOT) and the
host wall time of each stage of the ship, summed over its calls with
their p50 and max: the sender's extract (``extract_kv_payloads``), its
digest and send of each block and its wait for the ack; the receiver's
accept of each frame (``_accept``) and its one write a ship
(``write_kv_payloads``).  Host walls include waits
for the interpreter lock, which the two tick threads and every handler
thread of the process share.  The one-at-a-time runs print the 32- and
512-token prompts.  The first line is the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _timed(stats, name, fn):
    def call(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            stats[name].append((time.perf_counter() - t0) * 1e3)
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2,
                    help="runs with all 8 requests at once")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_disagg_profile: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops import _build
    from byteps_tpu_torch.serving import ServingEngine
    from byteps_tpu_torch.serving.disagg import ship

    print(json.dumps({"nvidia_smi": cs._smi()}), flush=True)
    _build.build(("paged_attention",))
    stats = collections.defaultdict(list)
    for cls, name, label in (
            (ServingEngine, "extract_kv_payloads", "extract"),
            (ServingEngine, "write_kv_payloads", "write"),
            (ship.KVStager, "_accept", "accept"),
            (ship, "_digest", "digest_send"),
            (ship, "_send_buffers", "send"),
            (ship, "_decode", "ack_wait")):
        setattr(cls, name, _timed(stats, label, getattr(cls, name)))
    cfg = TransformerConfig(**cs.LLAMA_3_2_1B, max_seq_len=cs.MAX_SEQ,
                            dtype=torch.bfloat16)
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, args.seed)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in cs.PROMPT_LENS]

    def run(tag, ps):
        stats.clear()
        _, line = cs._disagg_run(torch, model, ps, cs.NEW_TOKENS,
                                 dict(kv_blocks=1025), {}, cs.N_SLOTS,
                                 cs.MAX_SEQ)
        out = {"run": tag, **{k: line[k] for k in (
            "blocks", "ship_p50_ms", "ship_p99_ms", "ship_mb_per_s_p50",
            "extract_ms_p50", "ttft_with_ship_p50_ms",
            "decode_tpot_p50_ms", "tokens_per_s", "wall_s")}}
        for k, v in stats.items():
            out[k] = {"calls": len(v), "sum_ms": sum(v),
                      "p50_ms": float(np.median(v)), "max_ms": max(v)}
        return out

    for rep in range(args.reps):
        print(json.dumps(run(f"concurrent{rep}", prompts)), flush=True)
    for p in prompts:
        line = run(f"alone_{len(p)}", [p])
        if len(p) in (min(cs.PROMPT_LENS), max(cs.PROMPT_LENS)):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
