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

``from_jax_bert_params(params, cfg, dtype=torch.float32)`` does the same
for the trees of ``byteps_tpu.models.bert``: ``BertEncoder``'s (``embed``,
``pos``, the blocks, the RMSNorm ``ln_f``), or a head's, which nests the
encoder under ``"encoder"`` beside ``pooler`` / ``classifier``
(``BertClassifier``) or ``mlm_dense`` / ``mlm_ln`` / ``mlm_out``
(``BertMLM``): flax ``Dense`` heads, with biases, transposed to ``[out,
in]``.  The blocks are walked as the decoder's.

Every array in the tree must be consumed: a leftover (an unknown module,
a config mismatch) raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .transformer import TransformerConfig

__all__ = ["from_jax_params", "from_jax_bert_params"]


class _Carry:
    """One tree carried across: reads leaves by path, remembers which it
    read, and collects the state dict."""

    def __init__(self, params: dict, dtype: torch.dtype):
        self.tree = params.get("params", params)
        self.dtype = dtype
        self.used = set()
        self.sd: Dict[str, torch.Tensor] = {}

    def has(self, *path) -> bool:
        node = self.tree
        for p in path:
            if not isinstance(node, dict) or p not in node:
                return False
            node = node[p]
        return True

    def at(self, *path):
        node = self.tree
        for p in path:
            node = node[p]
        return node

    def raw(self, *path) -> np.ndarray:
        self.used.add(path)
        return np.asarray(self.at(*path))

    def take(self, *path) -> np.ndarray:
        return self.raw(*path).astype(np.float32)

    def w(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(self.dtype)

    @staticmethod
    def f32(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32))

    def embed(self, name: str, path: Tuple[str, ...]) -> None:
        self.sd[f"{name}.weight"] = self.w(self.take(*path, "embedding"))

    def norm(self, prefix: str, path: Tuple[str, ...], bias: bool) -> None:
        self.sd[f"{prefix}.scale"] = self.f32(self.take(*path, "scale"))
        if bias:
            self.sd[f"{prefix}.bias"] = self.f32(self.take(*path, "bias"))

    def dense(self, prefix: str, path: Tuple[str, ...], kernel_fn,
              bias: bool) -> None:
        if "scale" in self.at(*path):   # int8 kernel + fp32 per-output scale
            k = kernel_fn(self.raw(*path, "kernel"))
            self.sd[f"{prefix}.weight"] = torch.from_numpy(np.array(k, np.int8))
            self.sd[f"{prefix}.scale"] = self.f32(
                self.take(*path, "scale").reshape(-1))
        else:
            self.sd[f"{prefix}.weight"] = self.w(
                kernel_fn(self.take(*path, "kernel")))
        if bias:
            self.sd[f"{prefix}.bias"] = self.w(
                self.take(*path, "bias").reshape(-1))

    def blocks(self, cfg: TransformerConfig, path: Tuple[str, ...],
               prefix: str) -> None:
        """The decoder blocks ``block_{i}`` under ``path`` ->
        ``{prefix}.{i}.*``."""
        d = cfg.d_model
        layernorm = cfg.norm == "layernorm"
        for i in range(cfg.num_layers):
            blk = path + (f"block_{i}",)
            pre = f"{prefix}.{i}"
            self.norm(f"{pre}.ln1", blk + ("ln1",), layernorm)
            self.norm(f"{pre}.ln2", blk + ("ln2",), layernorm)
            for n in ("q", "k", "v"):
                self.dense(f"{pre}.attn.{n}", blk + ("attn", n),
                           lambda k: k.reshape(d, -1).T, cfg.use_bias)
            self.dense(f"{pre}.attn.o", blk + ("attn", "o"),
                       lambda k: k.reshape(-1, d).T, cfg.use_bias)
            mlp_names = ("gate", "up", "down") if cfg.mlp == "swiglu" \
                else ("up", "down")
            for n in mlp_names:
                self.dense(f"{pre}.mlp.{n}", blk + ("mlp", n), lambda k: k.T,
                           cfg.use_bias)

    def done(self) -> Dict[str, torch.Tensor]:
        """The state dict; raises if a leaf of the tree was not read."""
        leaves = []

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                leaves.append(path)

        walk(self.tree, ())
        left = [p for p in leaves if p not in self.used]
        if left:
            raise ValueError(f"JAX parameters not carried across: {left} "
                             f"(a config mismatch?)")
        return self.sd


def from_jax_params(params: dict, cfg: TransformerConfig,
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    c = _Carry(params, dtype)
    c.embed("embed", ("embed",))
    if cfg.pos_emb == "learned":
        c.embed("pos", ("pos",))
    c.blocks(cfg, (), "blocks")
    c.norm("ln_f", ("ln_f",), cfg.norm == "layernorm")
    if not cfg.tie_embeddings:
        c.dense("lm_head", ("lm_head",), lambda k: k.T, bias=False)
    return c.done()


def from_jax_bert_params(params: dict, cfg: TransformerConfig,
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    c = _Carry(params, dtype)
    head = c.has("encoder")
    enc, pre = (("encoder",), "encoder.") if head else ((), "")
    c.embed(f"{pre}embed", enc + ("embed",))
    c.embed(f"{pre}pos", enc + ("pos",))
    c.blocks(cfg, enc, f"{pre}blocks")
    c.norm(f"{pre}ln_f", enc + ("ln_f",), bias=False)    # always RMSNorm
    for name in ("pooler", "classifier", "mlm_dense", "mlm_out"):
        if c.has(name):
            c.dense(name, (name,), lambda k: k.T, bias=True)
    if c.has("mlm_ln"):
        c.norm("mlm_ln", ("mlm_ln",), bias=False)
    return c.done()
