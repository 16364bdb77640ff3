"""LLaMA architecture compatibility: HF ``LlamaForCausalLM`` weights onto
the port's ``Transformer`` — the port of ``byteps_tpu/integrations/
llama.py``.

RMSNorm, rotary embeddings (``pos_emb="rope"``, with llama3 or linear
frequency scaling), the gated SwiGLU MLP, grouped-query attention
(``num_kv_heads``), an explicit ``head_dim``, a tied or untied head: the
port runs every inference and training path on converted LLaMA weights.

Weight layouts: HF ``nn.Linear`` stores ``[out, in]``, which is the port's
``Dense`` layout too, so no projection is transposed (the JAX converter
transposes into flax's ``[in, out]``); :func:`convert_llama_state_dict`
checks every shape against the config instead.

* ``model.embed_tokens.weight [V, d]`` -> ``embed.weight``;
* ``layers.i.self_attn.{q,k,v,o}_proj`` -> ``blocks.i.attn.{q,k,v,o}``
  (HF's half-split ``rotate_half`` is the port's ``apply_rope``
  convention, so q/k need no permutation);
* ``layers.i.mlp.{gate,up,down}_proj`` -> ``blocks.i.mlp.{gate,up,down}``;
* ``input_layernorm`` / ``post_attention_layernorm`` / ``model.norm`` ->
  ``ln1`` / ``ln2`` / ``ln_f`` scales;
* ``lm_head.weight`` -> ``lm_head.weight``, absent when tied.

It needs no ``transformers`` import.  It reads both spellings of the
rotary settings: ``rope_theta`` and ``rope_scaling`` as attributes
(``transformers`` 4.x), or one ``rope_parameters`` dict that holds
``rope_theta`` too (5.x).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from ..common.device import resolve_device
from ..models.transformer import Transformer, TransformerConfig
from ._common import to_float32

__all__ = ["llama_config", "convert_llama_state_dict", "load_llama"]


def _rope_settings(hf_config):
    """``(theta, scaling dict or None)`` from either spelling."""
    scaling = (getattr(hf_config, "rope_scaling", None)
               or getattr(hf_config, "rope_parameters", None))
    theta = getattr(hf_config, "rope_theta", None)
    if theta is None:
        theta = (scaling or {}).get("rope_theta", 10000.0)
    if scaling:
        scaling = {k: v for k, v in scaling.items() if k != "rope_theta"}
    return float(theta), scaling


def llama_config(hf_config, dtype: torch.dtype = torch.float32,
                 **overrides) -> TransformerConfig:
    """``TransformerConfig`` mirroring an HF ``LlamaConfig``.

    Raises on config axes the port's model does not implement rather
    than silently diverging from the torch reference."""
    act = getattr(hf_config, "hidden_act", "silu")
    if act != "silu":
        raise ValueError(
            f"unsupported hidden_act {act!r}: the swiglu MLP hardcodes "
            "silu gating")
    theta, scaling = _rope_settings(hf_config)
    rope_scaling = None
    if scaling:
        rt = scaling.get("rope_type", scaling.get("type", "default"))
        if rt not in ("default", "linear", "llama3"):
            raise ValueError(
                f"unsupported rope_scaling type {rt!r}: implemented "
                "schedules are llama3 and linear "
                "(models.transformer._scaled_inv_freq)")
        if rt != "default":
            # tuple of sorted pairs keeps TransformerConfig hashable
            rope_scaling = tuple(sorted(
                (k, float(v) if isinstance(v, (int, float)) else v)
                for k, v in scaling.items()))
    if getattr(hf_config, "attention_bias", False) or getattr(
            hf_config, "mlp_bias", False):
        raise ValueError(
            "unsupported attention_bias/mlp_bias=True: LLaMA-family "
            "checkpoints are bias-free and so is this conversion")
    head_dim = getattr(hf_config, "head_dim", None)
    implied = hf_config.hidden_size // hf_config.num_attention_heads
    if head_dim == implied:
        head_dim = None  # explicit-but-redundant: derive it
    kw = dict(
        vocab_size=hf_config.vocab_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", None),
        d_model=hf_config.hidden_size,
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        dtype=dtype,
        causal=True,
        norm="rmsnorm",
        norm_eps=hf_config.rms_norm_eps,
        use_bias=False,
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        pos_emb="rope",
        rope_theta=theta,
        rope_scaling=rope_scaling,
        head_dim=head_dim,
        mlp="swiglu",
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def convert_llama_state_dict(sd: Mapping[str, Any],
                             cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """Map an HF ``LlamaForCausalLM.state_dict()`` to a state dict of the
    port's ``Transformer(cfg)`` (``cfg`` from :func:`llama_config`), fp32,
    on the weights' device.  Raises if a tensor's shape is not the one
    ``cfg`` implies."""
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.d_head
    ff = cfg.d_ff
    out: Dict[str, torch.Tensor] = {}

    def put(port, hf, shape):
        t = to_float32(sd[hf])
        if tuple(t.shape) != shape:
            raise ValueError(f"{hf}: shape {tuple(t.shape)}, the config "
                             f"implies {shape} (port {port})")
        out[port] = t

    put("embed.weight", "model.embed_tokens.weight", (cfg.vocab_size, d))
    put("ln_f.scale", "model.norm.weight", (d,))
    for i in range(cfg.num_layers):
        p, q = f"model.layers.{i}", f"blocks.{i}"
        put(f"{q}.ln1.scale", f"{p}.input_layernorm.weight", (d,))
        put(f"{q}.ln2.scale", f"{p}.post_attention_layernorm.weight", (d,))
        for n, rows in (("q", H * Dh), ("k", KV * Dh), ("v", KV * Dh)):
            put(f"{q}.attn.{n}.weight", f"{p}.self_attn.{n}_proj.weight",
                (rows, d))
        put(f"{q}.attn.o.weight", f"{p}.self_attn.o_proj.weight", (d, H * Dh))
        for n in ("gate", "up"):
            put(f"{q}.mlp.{n}.weight", f"{p}.mlp.{n}_proj.weight", (ff, d))
        put(f"{q}.mlp.down.weight", f"{p}.mlp.down_proj.weight", (d, ff))
    if not cfg.tie_embeddings:
        put("lm_head.weight", "lm_head.weight", (cfg.vocab_size, d))
    return out


def load_llama(hf_model, dtype: torch.dtype = torch.float32, device=None,
               **overrides) -> Transformer:
    """The port's ``Transformer`` with a live ``LlamaForCausalLM``'s
    weights, on ``device`` (``cuda`` unless the caller names another;
    without a GPU it raises)."""
    cfg = llama_config(hf_model.config, dtype=dtype, **overrides)
    model = Transformer(cfg, device=resolve_device(device))
    model.load_state_dict(
        convert_llama_state_dict(hf_model.state_dict(), cfg), strict=True)
    return model
