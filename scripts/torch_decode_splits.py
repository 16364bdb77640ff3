#!/usr/bin/env python3
"""Time the port's decode-attention kernel with a bf16 q (the design on
tensor cores) under several split plans, at chip_smoke.py phase 16's main
shape (Llama-3.2-1B's heads: H=32, KV=8, D=64; B=8, S=2048, pos 2047).

    python3 scripts/torch_decode_splits.py [--splits 1 2 4 8 16]

Each time is device ms per call from CUDA graphs of 20 (L2 flush, call)
pairs less the flushes alone (chip_smoke.py's ``_graph_ms``), three
estimates, for a bf16 and an int8 cache; ``plan`` null is the wrapper's
own (``_splits``).  The first line is the card's ``nvidia-smi`` name and
power limit.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 4, 8,
                                                              16])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_splits: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from byteps_tpu_torch.ops import decode_attention as da

    print(cs._smi(), flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    c = dict(cs.DECODE_MAIN)
    pos = c["pos"]
    n = pos // da.CHUNK + 1
    own = da._splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for mode in ("bfloat16", "int8"):
        q, ck, cv, ks, vs = cs._decode_inputs(torch, 0, c, mode)

        def call():
            return da.decode_attention(q, ck, cv, pos, k_scale=ks,
                                       v_scale=vs)

        for k in [None, *args.splits]:
            per = None if k is None else math.ceil(n / k)
            da._splits = (own if k is None else
                          lambda *a, per=per: (math.ceil(n / per), per))
            plan = da._splits(c["B"], c["KV"], n, sms, True)
            ms = [cs._graph_ms(torch, call, flush) for _ in range(3)]
            print(json.dumps({"cache": mode, "plan": None if k is None
                              else list(plan), "splits_per": list(plan),
                              "ms": ms}), flush=True)
        da._splits = own
    return 0


if __name__ == "__main__":
    sys.exit(main())
