"""GPT-2 architecture compatibility: HF ``GPT2LMHeadModel`` weights onto
the port's ``Transformer`` — the port of ``byteps_tpu/integrations/
gpt2.py``.

``TransformerConfig`` has the three axes GPT-2 needs (pre-norm LayerNorm
with bias, biased projections, the LM head tied to the input embedding),
so every path of the port runs on GPT-2 weights: flash prefill, cached
generation on the decode kernel, beam search, speculative decoding, int8
weight-only quantization, and training through the fused LM-head
cross-entropy.

Weight layouts (HF ``Conv1D`` stores ``[in, out]``; the port's ``Dense``
is ``nn.Linear``'s ``[out, in]``, so every projection is transposed):

* ``wte [V, d]`` -> ``embed.weight``; ``wpe [P, d]`` -> ``pos.weight``;
* ``h.i.attn.c_attn [d, 3d]`` -> thirds along ``out`` -> q/k/v ``[d,
  d]`` transposed (HF merges heads head-major, as the port's views);
* ``h.i.attn.c_proj``, ``h.i.mlp.c_fc`` / ``c_proj`` -> ``attn.o``,
  ``mlp.up`` / ``mlp.down``, transposed, with their biases;
* ``ln_1`` / ``ln_2`` / ``ln_f`` -> ``ln1`` / ``ln2`` / ``ln_f`` scale and
  bias;
* the head is tied: no tensor (``lm_head.weight`` only when a caller
  unties it).

It needs no ``transformers`` import: it reads an HF config's attributes
and a state dict.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from ..common.device import resolve_device
from ..models.transformer import Transformer, TransformerConfig
from ._common import to_float32

__all__ = ["gpt2_config", "convert_gpt2_state_dict", "load_gpt2"]


def gpt2_config(hf_config, dtype: torch.dtype = torch.float32,
                **overrides) -> TransformerConfig:
    """``TransformerConfig`` mirroring an HF ``GPT2Config``.

    Raises on config axes the port's model does not implement rather
    than silently diverging from the torch reference."""
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"unsupported activation_function {act!r}: the framework MLP "
            "hardcodes tanh-approximate GELU (gelu_new)")
    for flag in ("scale_attn_by_inverse_layer_idx",
                 "reorder_and_upcast_attn"):
        if getattr(hf_config, flag, False):
            raise ValueError(f"unsupported GPT2Config.{flag}=True")
    kw = dict(
        vocab_size=hf_config.vocab_size,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        d_model=hf_config.n_embd,
        d_ff=(hf_config.n_inner if hf_config.n_inner is not None
              else 4 * hf_config.n_embd),
        max_seq_len=hf_config.n_positions,
        dtype=dtype,
        causal=True,
        norm="layernorm",
        norm_eps=hf_config.layer_norm_epsilon,
        use_bias=True,
        tie_embeddings=True,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def convert_gpt2_state_dict(sd: Mapping[str, Any],
                            cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """Map an HF ``GPT2LMHeadModel.state_dict()`` to a state dict of the
    port's ``Transformer(cfg)`` (``cfg`` from :func:`gpt2_config`), fp32,
    on the weights' device."""
    def g(key):
        return to_float32(sd[f"transformer.{key}"])

    out: Dict[str, torch.Tensor] = {
        "embed.weight": g("wte.weight"),
        "pos.weight": g("wpe.weight"),
        "ln_f.scale": g("ln_f.weight"),
        "ln_f.bias": g("ln_f.bias"),
    }
    for i in range(cfg.num_layers):
        p, q = f"h.{i}", f"blocks.{i}"
        for hf, port in (("ln_1", "ln1"), ("ln_2", "ln2")):
            out[f"{q}.{port}.scale"] = g(f"{p}.{hf}.weight")
            out[f"{q}.{port}.bias"] = g(f"{p}.{hf}.bias")
        w_attn = g(f"{p}.attn.c_attn.weight")            # [d, 3d]
        b_attn = g(f"{p}.attn.c_attn.bias")              # [3d]
        for n, w, b in zip("qkv", w_attn.chunk(3, dim=1),
                           b_attn.chunk(3, dim=0)):
            out[f"{q}.attn.{n}.weight"] = w.t().contiguous()
            out[f"{q}.attn.{n}.bias"] = b.contiguous()
        for hf, port in (("attn.c_proj", "attn.o"), ("mlp.c_fc", "mlp.up"),
                         ("mlp.c_proj", "mlp.down")):
            out[f"{q}.{port}.weight"] = g(f"{p}.{hf}.weight").t().contiguous()
            out[f"{q}.{port}.bias"] = g(f"{p}.{hf}.bias")
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = to_float32(sd["lm_head.weight"])
    return out


def load_gpt2(hf_model, dtype: torch.dtype = torch.float32, device=None,
              **overrides) -> Transformer:
    """The port's ``Transformer`` with a live ``GPT2LMHeadModel``'s
    weights, on ``device`` (``cuda`` unless the caller names another;
    without a GPU it raises)."""
    cfg = gpt2_config(hf_model.config, dtype=dtype, **overrides)
    model = Transformer(cfg, device=resolve_device(device))
    model.load_state_dict(convert_gpt2_state_dict(hf_model.state_dict(), cfg),
                          strict=True)
    return model
