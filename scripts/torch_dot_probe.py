#!/usr/bin/env python3
"""Probe of the int8 weight-only product on one NVIDIA GPU — the port's
counterpart of ``scripts/dot_probe.py``.

    python3 scripts/torch_dot_probe.py [--steps 255] [--reps 6]

x [8, 768] bf16 against W [768, 3072] (decode's MLP-up shape of the
probe; the port keeps W as ``[3072, 768]``, ``nn.Linear``'s layout), each
variant inside a dependent chain of ``--steps`` steps, ``x <- tanh(y[:,
:768])`` (the same weight re-read every step, as in decode):

* ``int8 kernel`` — ``ops.quant_dot.quant_linear`` on the int8 weight and
  its per-column scales (the hand-written kernel, in the design its rule
  names for 8 bf16 rows: ``swap``; the line says which);
* ``int8 tile`` — the same through the first design
  (``quant_linear_design(..., design=TILE)``);
* ``bf16 F.linear`` — cuBLAS on the dequantized bf16 weight;
* ``int8 plain`` — the kernel's plain PyTorch version.

Each chain is captured once in a CUDA graph and replayed, so the host's
launch cost drops out as the JAX probe's one compiled scan drops it.
Per step, CUDA events over a replay minus a replay of the ``tanh`` step
alone, best of ``--reps``: microseconds per dot and the weight's bytes
over that time (the 2.4 MB int8 / 4.7 MB bf16 weight stays in the 50 MB
L2 across the chain, so the rate may pass HBM's).  Prints the card's
``nvidia-smi`` name and power limit first, then the design the rule
names.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

M, K, N = 8, 768, 3072


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=255)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_dot_probe: no CUDA device; this script needs a GPU",
              file=sys.stderr)
        return 1
    from byteps_tpu_torch.ops import quant_dot as qd

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(args.seed)
    x0 = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    wf = torch.randn((N, K), generator=g, device="cuda")
    w8, scale = qd.quantize_weight(wf)
    wbf = (w8.float() * scale[:, None]).to(torch.bfloat16)
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    design = qd.DESIGNS[qd._design(x0.dtype, M, N, K, x0.data_ptr(),
                                   w8.data_ptr(), out.data_ptr())]
    print(f"int8 kernel design: {design} (x [{M}, {K}] bf16)", flush=True)
    variants = {
        "int8 kernel   ": (lambda x: qd.quant_linear(x, w8, scale), N * K),
        "int8 tile     ": (lambda x: qd.quant_linear_design(
            x, w8, scale, design=qd.TILE), N * K),
        "bf16 F.linear ": (lambda x: F.linear(x, wbf), 2 * N * K),
        "int8 plain    ": (lambda x: qd.quant_linear_reference(x, w8, scale),
                           N * K),
        "tanh step only": (lambda x: x, 0),
    }

    def chain(dot):
        x = x0
        for _ in range(args.steps):
            x = torch.tanh(dot(x)[:, :K]).to(torch.bfloat16)
        return x

    graphs = {}
    for n, (dot, _) in variants.items():
        chain(dot)                           # warm-up (and the kernel build)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = chain(dot)
        graphs[n] = (graph, out)
    best = {n: float("inf") for n in variants}
    for _ in range(args.reps):               # interleaved against drift
        for n, (graph, out) in graphs.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"{n}: non-finite chain output")
            best[n] = min(best[n], e0.elapsed_time(e1) * 1e3 / args.steps)
    base = best["tanh step only"]
    for n, (_, nbytes) in variants.items():
        if not nbytes:
            print(f"{n}: {best[n]:7.2f} us/step (subtracted below)")
            continue
        us = best[n] - base
        print(f"{n}: {us:7.2f} us/dot  ({nbytes / 1e6:.1f} MB -> "
              f"{nbytes / 1e3 / us:.0f} GB/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
