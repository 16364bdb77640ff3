#!/usr/bin/env python3
"""Where a training step of the port (byteps_tpu_torch) spends its time on
the GPU: Llama-3.2-1B at full width, bf16 compute on fp32 weights,
random weights, ``attn_impl="flash"``, the plain LM head (or, with
``--fused-head``, the fused LM-head cross-entropy kernels), fused AdamW.

    python3 scripts/torch_train_profile.py [--fused-head] [--steps 3]
        [--batch 4] [--seed 0] [--out FILE]

The same configuration as ``chip_smoke.py``'s training phase (T=2048,
one fixed batch of random tokens).  After one warm-up step it measures:

* host wall per step of ``Trainer.fit`` ending in the loss read-back,
  which synchronizes;
* ``torch.profiler`` over the same number of steps: device busy and
  idle share of the wall (union of kernel intervals / profiled wall),
  kernel launches per step, and device time per step of the three
  flash kernels, the fused-CE kernels (forward with its combine,
  dlogits, dx, dW), the bf16 GEMMs, the plain LM head's fp32 GEMMs, the
  softmax / cross-entropy kernels, the optimizer, and the top kernels
  by name;
* CUDA events around the parts of one step, driven piece by piece as
  ``lm_loss_fn`` composes them: the trunk forward (``hidden``), the
  head and cross-entropy forward, the whole backward, and the
  optimizer step.

Prints one JSON line per measurement, the ``nvidia-smi`` name and power
limit first; ``--out`` also writes them to a file.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
SEQ = 2048
# kernel-name classes, first match wins
CLASSES = (("fce_fwd", re.compile(r"fce_fwd")),
           ("fce_dlogits", re.compile(r"fce_dlogits_kernel")),
           ("fce_dx", re.compile(r"fce_dx_kernel")),
           ("fce_dw", re.compile(r"fce_dw_kernel")),
           ("flash_fwd", re.compile(r"flash_fwd_(mma_)?kernel")),
           ("flash_dq", re.compile(r"flash_bwd_dq_(mma_)?kernel")),
           ("flash_dkv", re.compile(r"flash_bwd_dkv_(mma_)?kernel")),
           ("optimizer", re.compile(r"adam", re.I)),
           # the only fp32 GEMMs of the step are the LM head's three
           ("gemm_fp32_head", re.compile(r"f32f32|sgemm", re.I)),
           ("gemm_bf16", re.compile(r"gemm|cutlass|nvjet|xmma|sm90_|splitk",
                                    re.I)),
           ("softmax_ce", re.compile(r"softmax|nll_loss|cross_entropy",
                                     re.I)))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fused-head", action="store_true",
                    help="lm_loss_fn(fused_head=True): the fused CE kernels")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.ops.fused_cross_entropy import \
        fused_linear_cross_entropy
    from byteps_tpu_torch.training import Trainer, lm_loss_fn

    rows = []

    def emit(obj):
        rows.append(obj)
        print(json.dumps(obj), flush=True)

    emit({"measure": "device", "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]})
    cfg = TransformerConfig(**LLAMA_3_2_1B, max_seq_len=SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    model = Transformer(cfg, device="cuda")
    init_weights(model, args.seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4, fused=True)
    trainer = Trainer(lm_loss_fn(model, fused_head=args.fused_head), opt,
                      log_every=0)
    toks = np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, size=(args.batch, SEQ))
    batch = {"tokens": torch.from_numpy(toks).cuda()}
    trainer.fit(model, {}, [batch])  # warm-up
    trainer.metrics["loss"].item()

    walls = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(model, {}, [batch])
        trainer.metrics["loss"].item()
        walls.append((time.perf_counter() - t0) * 1e3)
    emit({"measure": "step_wall_ms", "fused_head": args.fused_head,
          "steps": args.steps,
          "batch": [args.batch, SEQ], "p50": float(np.median(walls)),
          "min": float(np.min(walls)), "max": float(np.max(walls)),
          "tokens_per_s": args.batch * SEQ / (float(np.median(walls)) / 1e3)})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.fit(model, {}, [batch])
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    # device kernels only: the profiler also puts user annotations (the
    # optimizer's "Optimizer.step#..." range) on the device timeline
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    if not kernels:
        emit({"measure": "profile", "error": "the profiler recorded no "
              "device activity; see the CUDA-event split below"})
    else:
        busy = _busy_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
        emit({"measure": "profile", "steps": args.steps,
              "wall_ms_per_step": prof_wall_us / args.steps / 1e3,
              "device_busy_ms_per_step": busy / args.steps / 1e3,
              "device_idle_share": 1.0 - busy / prof_wall_us,
              "kernel_launches_per_step": len(kernels) / args.steps})
        by_class, by_name = {}, {}
        for e in kernels:
            t = e.time_range.elapsed_us()
            cls = next((c for c, rx in CLASSES if rx.search(e.name)),
                       "other")
            n, s = by_class.get(cls, (0, 0.0))
            by_class[cls] = (n + 1, s + t)
            n, s = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, s + t)
        for cls, (n, t) in sorted(by_class.items(), key=lambda kv: -kv[1][1]):
            emit({"measure": "class", "class": cls,
                  "launches_per_step": n / args.steps,
                  "device_ms_per_step": t / args.steps / 1e3})
        for name, (n, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:12]:
            emit({"measure": "kernel", "name": name[:90],
                  "launches_per_step": n / args.steps,
                  "device_ms_per_step": t / args.steps / 1e3})

    # one step piece by piece, as lm_loss_fn composes it
    tokens = batch["tokens"]
    t = torch.roll(tokens, -1, dims=1)
    t[:, -1] = -100
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    if args.fused_head:
        h = model.hidden(tokens)
        ev[1].record()
        per_row = fused_linear_cross_entropy(
            h.reshape(-1, cfg.d_model), model.head_weight().t(), t.reshape(-1))
        loss = per_row.sum() / (t >= 0).sum()
    else:
        h = model.hidden(tokens)[:, :-1]
        ev[1].record()
        logits = model.logits(h)
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               t[:, :-1].reshape(-1).long())
    ev[2].record()
    loss.backward()
    ev[3].record()
    opt.step()
    ev[4].record()
    torch.cuda.synchronize()
    parts = ("trunk_forward", "head_ce_forward", "backward", "optimizer")
    emit({"measure": "step_parts_ms",
          **{p: ev[i].elapsed_time(ev[i + 1]) for i, p in enumerate(parts)},
          "step": ev[0].elapsed_time(ev[4])})
    emit({"measure": "memory", "max_memory_allocated_gb":
          torch.cuda.max_memory_allocated() / 1e9})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
