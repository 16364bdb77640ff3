"""Carry a JAX ``Transformer`` parameter tree across to the port.

``from_jax_params(params, cfg, dtype=torch.float32)`` takes the flax
tree of ``byteps_tpu.models.transformer.Transformer`` as numpy arrays
(the ``{"params": ...}`` wrapper optional) and returns a ``state_dict``
for :class:`byteps_tpu_torch.models.transformer.Transformer`, weights in
``dtype`` (fp32, flax's parameter dtype, for training; ``cfg.dtype``
for a model built with ``param_dtype=cfg.dtype``).  Every map is a
linear re-layout, so a JAX *gradient* tree (the same structure)
converts the same way, for comparing gradients leaf by leaf.  It needs
numpy only, never jax.  Layouts (JAX -> ``nn.Linear``'s ``[out, in]``):

* q/k/v kernels ``[d_model, H|KV, D]`` -> ``[H|KV * D, d_model]``;
* the o kernel ``[H, D, d_model]`` (``QuantDense`` ``in_axes=2``) ->
  ``[d_model, H * D]``;
* ``embed`` ``[V, d_model]`` and ``pos`` ``[max_seq, d_model]`` as is;
* mlp ``gate``/``up`` ``[d_model, d_ff]`` and ``down`` ``[d_ff,
  d_model]`` transposed;
* norms carry ``scale`` (and ``bias`` for layernorm), kept fp32;
* ``lm_head`` ``[d_model, V]`` transposed, absent when tied.

A tree quantized by JAX ``inference.quantize_params`` carries across
too: each int8 ``kernel`` is re-laid out as its float counterpart and
stays int8, and its fp32 ``scale`` becomes the ``Dense``'s ``scale``
buffer, flattened to ``[out]`` (q/k/v ``[H|KV, D]`` -> ``[H*D]``; o
``[d_model]``; MLP ``[d_ff]`` / ``[d_model]``; head ``[V]``).  Load it
into a model quantized first (``byteps_tpu_torch.inference
.quantize_params``), which has those int8 weights and buffers.

Every array in the tree must be consumed: a leftover (an unknown module,
a config mismatch) raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .transformer import TransformerConfig

__all__ = ["from_jax_params"]


def from_jax_params(params: dict, cfg: TransformerConfig,
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    tree = params.get("params", params)
    used = set()

    def at(*path):
        node = tree
        for p in path:
            node = node[p]
        return node

    def raw(*path) -> np.ndarray:
        used.add(path)
        return np.asarray(at(*path))

    def take(*path) -> np.ndarray:
        return raw(*path).astype(np.float32)

    def w(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(dtype)

    def f32(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32))

    sd: Dict[str, torch.Tensor] = {}
    d = cfg.d_model
    sd["embed.weight"] = w(take("embed", "embedding"))
    if cfg.pos_emb == "learned":
        sd["pos.weight"] = w(take("pos", "embedding"))

    def norm(prefix, *path):
        sd[f"{prefix}.scale"] = f32(take(*path, "scale"))
        if cfg.norm == "layernorm":
            sd[f"{prefix}.bias"] = f32(take(*path, "bias"))

    def dense(prefix, path, kernel_fn, bias=cfg.use_bias):
        if "scale" in at(*path):   # int8 kernel + fp32 per-output scale
            k = kernel_fn(raw(*path, "kernel"))
            sd[f"{prefix}.weight"] = torch.from_numpy(np.array(k, np.int8))
            sd[f"{prefix}.scale"] = f32(take(*path, "scale").reshape(-1))
        else:
            sd[f"{prefix}.weight"] = w(kernel_fn(take(*path, "kernel")))
        if bias:
            sd[f"{prefix}.bias"] = w(take(*path, "bias").reshape(-1))

    for i in range(cfg.num_layers):
        blk = f"block_{i}"
        pre = f"blocks.{i}"
        norm(f"{pre}.ln1", blk, "ln1")
        norm(f"{pre}.ln2", blk, "ln2")
        for n in ("q", "k", "v"):
            dense(f"{pre}.attn.{n}", (blk, "attn", n),
                  lambda k: k.reshape(d, -1).T)
        dense(f"{pre}.attn.o", (blk, "attn", "o"),
              lambda k: k.reshape(-1, d).T)
        mlp_names = ("gate", "up", "down") if cfg.mlp == "swiglu" \
            else ("up", "down")
        for n in mlp_names:
            dense(f"{pre}.mlp.{n}", (blk, "mlp", n), lambda k: k.T)
    norm("ln_f", "ln_f")
    if not cfg.tie_embeddings:
        dense("lm_head", ("lm_head",), lambda k: k.T, bias=False)

    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            leaves.append(path)

    walk(tree, ())
    left = [p for p in leaves if p not in used]
    if left:
        raise ValueError(f"JAX parameters not carried across: {left} "
                         f"(a config mismatch?)")
    return sd
