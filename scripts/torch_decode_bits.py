#!/usr/bin/env python3
"""Whether two checkouts of the port give the same bits on the decode
kernel's int-position path: every chip_smoke.py phase-16 case (bf16,
int8 and fp32 modes) and phase 15's full-width greedy generation
(Llama-3.2-1B, bf16, B=8, prompt 1920, 128 new tokens; the flat fp cache
and the flat int8 cache, one decode-kernel launch a layer a step).

    python3 scripts/torch_decode_bits.py --against DIR

``DIR`` holds another checkout (for example an unpacked ``git archive``
of a parent commit in a gitignored directory).  Each checkout runs in a
fresh process with its own package, its own ``chip_smoke.py`` inputs and
its own kernel build, and saves its outputs; this one, then ``DIR``.
Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per case and a summary; exits 1 unless every output is bit-identical.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dump(root: str, out: str, seed: int) -> None:
    """Run the cases with the package and chip_smoke.py under ``root``;
    save ``{name: tensor}`` to ``out``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from byteps_tpu_torch.inference import make_generate_fn
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    res = {}
    for mode in ("bfloat16", "int8", "float32"):
        for name, over, _ in cs.DECODE_CASES:
            _, _, _, call = cs._decode_call(torch, seed, over, mode)
            res[f"phase16/{name}/{mode}"] = call().cpu()
    cfg = TransformerConfig(**cs.LLAMA_3_2_1B, max_seq_len=cs.MAX_SEQ,
                            dtype=torch.bfloat16, attn_impl="flash")
    model = Transformer(cfg, device="cuda", param_dtype=torch.bfloat16)
    init_weights(model, seed)
    import numpy as np
    prompt = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(cs.GEN_B, cs.GEN_PROMPT))).cuda()
    for name, kw in (("fp_flat", {"cache_layout": "flat"}),
                     ("int8_cache", {"kv_quant": True,
                                     "cache_layout": "flat"})):
        fn = make_generate_fn(model, cs.GEN_NEW, temperature=0, **kw)
        res[f"phase15/{name}"] = fn(prompt)["tokens"].cpu()
    torch.save(res, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True,
                    help="the other checkout's root directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dump:
        dump(args.root, args.dump, args.seed)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_bits: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    other = os.path.abspath(args.against)
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, root in (("this", HERE), ("other", other)):
            path = os.path.join(tmp, f"{tag}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--against", other, "--seed", str(args.seed),
                            "--dump", path, "--root", root], check=True,
                           cwd=root)
            outs[tag] = torch.load(path)
    same = 0
    for name, a in outs["this"].items():
        b = outs["other"].get(name)
        eq = b is not None and torch.equal(a, b)
        same += eq
        print(json.dumps({"case": name, "bit_identical": bool(eq)}),
              flush=True)
    print(json.dumps({"cases": len(outs["this"]), "bit_identical": same,
                      "this": HERE, "other": other}), flush=True)
    return 0 if same == len(outs["this"]) == len(outs["other"]) else 1


if __name__ == "__main__":
    sys.exit(main())
