#!/usr/bin/env python3
"""Where the fp32 flash-attention gradients of the card and of the CPU
plain versions part, and which side is nearer the exact values.

    python3 scripts/torch_flash_grad_drift.py [--draws 8] [--out FILE]

The inputs of ``tests/test_torch_kernels_cuda.py::
test_flash_autograd_on_the_card_matches_the_cpu_function`` (numpy seed 3:
B 2, T 150, 8 heads over 2 KV heads, D 64, causal, fp32, and a cotangent
of lse) go through ``flash_attention_with_lse`` on the card (the
kernels), on the CPU at the host's thread count and at one thread (the
plain versions), and on the CPU in fp64 (the exact values to within
fp64 rounding).  The test draws its lse cotangent from the card's
default generator without a seed, so its value depends on what ran
before it in the process; this script takes the draw a fresh process
makes first, then ``--draws`` more from seeded generators.

For each draw and each of o, lse, dq, dk, dv: the largest |card - CPU|
with its element, that element's magnitude, and each side's distance
from fp64 there; and each side's largest distance from fp64 over the
tensor.  Then, each in a fresh process of this script (``--probe``), the
CPU plain versions' first three fp32 calls on these inputs, each one's
largest distance from fp64: as they are, with oneDNN off
(``torch.backends.mkldnn``), and at one thread from the start.  Prints
the host's CPU model and flags, torch's CPU capability and thread count,
and the card's ``nvidia-smi`` name and power limit.  Needs a CUDA device
(the probes need none).
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

NAMES = ("o", "lse", "dq", "dk", "dv")


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def _cpu_flags() -> list:
    """The matrix and vector extensions /proc/cpuinfo lists."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return sorted(w for w in line.split(":", 1)[1].split()
                                  if w.startswith(("amx", "avx512")))
    except OSError:
        pass
    return []


def _grads(torch, fa, q, k, v, do, dlse, dev, dtype, threads=None):
    n = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        qq, kk, vv = (t.detach().to(dev, dtype).requires_grad_()
                      for t in (q, k, v))
        o, lse = fa.flash_attention_with_lse(qq, kk, vv, causal=True)
        torch.autograd.backward((o, lse), (do.to(dev, dtype),
                                           dlse.to(dev, dtype)))
        return [t.detach().cpu().double() for t in
                (o, lse, qq.grad, kk.grad, vv.grad)]
    finally:
        torch.set_num_threads(n)


def _inputs(np, torch):
    """The test's q, k, v, dO (numpy seed 3) and a fixed lse cotangent."""
    rng = np.random.RandomState(3)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    return (t(2, 150, 8, 64), t(2, 150, 2, 64), t(2, 150, 2, 64),
            t(2, 150, 8, 64), t(2, 150, 8))


def _probe(mode: str) -> int:
    """Three CPU fp32 calls in a fresh process under ``mode``, each one's
    largest distance from fp64 per tensor, as one JSON line."""
    import numpy as np
    import torch

    from byteps_tpu_torch.ops import flash_attention as fa

    if mode == "no_onednn":
        torch.backends.mkldnn.enabled = False
    if mode == "one_thread":
        torch.set_num_threads(1)
    q, k, v, do, dlse = _inputs(np, torch)
    calls = [_grads(torch, fa, q, k, v, do, dlse, "cpu", torch.float32)
             for _ in range(3)]
    exact = _grads(torch, fa, q, k, v, do, dlse, "cpu", torch.float64)
    print(json.dumps({"measure": "first_calls", "mode": mode, **{
        n: [(c[i] - exact[i]).abs().max().item() for c in calls]
        for i, n in enumerate(NAMES)}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--out", default="")
    ap.add_argument("--probe", default="",
                    choices=("", "as_is", "no_onednn", "one_thread"))
    args = ap.parse_args()
    if args.probe:
        return _probe(args.probe)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_grad_drift: needs a CUDA device", file=sys.stderr)
        return 1
    from byteps_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []

    def emit(obj):
        rows.append(obj)
        print(json.dumps(obj), flush=True)

    emit({"measure": "host", "cpu": _cpu_model(), "cpu_flags": _cpu_flags(),
          "cpu_capability": torch.backends.cpu.get_cpu_capability(),
          "threads": torch.get_num_threads(), "torch": torch.__version__,
          "nvidia_smi": subprocess.run(
              ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"], capture_output=True,
              text=True).stdout.strip()})
    q, k, v, do, _ = _inputs(np, torch)
    draws = [("default_first", torch.randn(2, 150, 8, device="cuda").cpu())]
    for i in range(args.draws):
        g = torch.Generator(device="cuda")
        g.manual_seed(i)
        draws.append((f"seed{i}", torch.randn(2, 150, 8, device="cuda",
                                              generator=g).cpu()))
    for name, dlse in draws:
        card = _grads(torch, fa, q, k, v, do, dlse, "cuda", torch.float32)
        cpu = _grads(torch, fa, q, k, v, do, dlse, "cpu", torch.float32)
        cpu1 = _grads(torch, fa, q, k, v, do, dlse, "cpu", torch.float32, 1)
        exact = _grads(torch, fa, q, k, v, do, dlse, "cpu", torch.float64)
        line = {"measure": "draw", "draw": name}
        for n, a, b, b1, e in zip(NAMES, card, cpu, cpu1, exact):
            diff = (a - b).abs()
            i = int(diff.argmax())
            idx = list(np.unravel_index(i, tuple(diff.shape)))
            line[n] = {
                "card_vs_cpu": diff.max().item(),
                "element": [int(x) for x in idx],
                "magnitude": e.reshape(-1)[i].abs().item(),
                "card_vs_fp64_there": (a - e).reshape(-1)[i].abs().item(),
                "cpu_vs_fp64_there": (b - e).reshape(-1)[i].abs().item(),
                "card_vs_fp64": (a - e).abs().max().item(),
                "cpu_vs_fp64": (b - e).abs().max().item(),
                "cpu1_vs_cpu": (b1 - b).abs().max().item(),
                "max_magnitude": e.abs().max().item()}
        emit(line)
    for mode in ("as_is", "no_onednn", "one_thread"):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--probe", mode], capture_output=True, text=True,
                           timeout=600)
        if r.returncode:
            raise RuntimeError(f"probe {mode} failed: {r.stderr[-2000:]}")
        emit(json.loads(r.stdout.strip().splitlines()[-1]))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
