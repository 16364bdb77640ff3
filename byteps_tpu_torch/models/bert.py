"""BERT-style bidirectional encoder — the port of
``byteps_tpu/models/bert.py``.

The JAX package's BERT-base fine-tune (``BASELINE.json`` configs[3]):
the decoder's :class:`~byteps_tpu_torch.models.transformer.Block` stack
with ``causal=False``, a learned position table, and the two standard
heads, sequence classification (fine-tune) and masked LM (pretrain).  It
is the JAX module's computation, not HF BERT's: no token-type embedding,
no embedding norm, and the final norm is an RMSNorm.

A padding ``attention_mask [B, T]`` (1 = token, 0 = pad) reaches every
block as its key mask.  Under ``attn_impl="flash"`` it rides the flash
kernels' segment ids, non-causal (pads see only pads, so valid positions
equal the masked softmax); under ``"local"`` padded keys leave every
softmax.  Padded positions are zeroed after the final norm.

Modules take an explicit ``device`` (``cuda`` unless the caller names
another; without a GPU they raise) and ``param_dtype`` (fp32, flax's
parameter dtype: weights are cast to ``cfg.dtype`` at use).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..common.device import resolve_device
from .transformer import Block, Dense, RMSNorm, TransformerConfig

__all__ = ["bert_config", "BertEncoder", "BertClassifier", "BertMLM"]

# flax ``nn.RMSNorm``'s default epsilon: the encoder's ``ln_f`` and the
# MLM head's norm use it whatever ``cfg.norm_eps`` says
_FLAX_RMS_EPS = 1e-6


def bert_config(vocab_size: int = 30522, num_layers: int = 12,
                num_heads: int = 12, d_model: int = 768, d_ff: int = 3072,
                max_seq_len: int = 512, dtype: torch.dtype = torch.bfloat16,
                **kw) -> TransformerConfig:
    """BERT-base shape by default, ``causal=False``.  ``attn_impl`` keeps
    the config's default ``"local"``; pass ``attn_impl="flash"`` for the
    flash kernels."""
    return TransformerConfig(
        vocab_size=vocab_size, num_layers=num_layers, num_heads=num_heads,
        d_model=d_model, d_ff=d_ff, max_seq_len=max_seq_len, dtype=dtype,
        causal=False, **kw)


class BertEncoder(nn.Module):
    """Token + position embeddings -> ``cfg.num_layers`` bidirectional
    blocks -> RMSNorm -> hidden states ``[B, T, d_model]`` in
    ``cfg.dtype``, zero at padded positions."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        if cfg.causal:
            raise ValueError("BertEncoder requires causal=False")
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device,
                                  dtype=param_dtype)
        self.pos = nn.Embedding(cfg.max_seq_len, cfg.d_model, device=device,
                                dtype=param_dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, device, param_dtype) for _ in range(cfg.num_layers))
        self.ln_f = RMSNorm(cfg.d_model, _FLAX_RMS_EPS, cfg.dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def forward(self, tokens: torch.Tensor,
                attention_mask: torch.Tensor = None) -> torch.Tensor:
        cdt = self.cfg.dtype
        T = tokens.shape[1]
        x = (self.embed(tokens).to(cdt)
             + self.pos(torch.arange(T, device=tokens.device)).to(cdt)[None])
        for block in self.blocks:
            x = block(x, key_mask=attention_mask)
        x = self.ln_f(x)
        if attention_mask is not None:
            x = x * attention_mask[..., None].to(x.dtype)
        return x


class BertClassifier(nn.Module):
    """Sequence classification (CLS pooling): the first position's hidden
    state through the ``pooler`` dense in ``cfg.dtype`` and tanh, then
    the ``classifier`` dense in fp32 -> fp32 logits ``[B, num_classes]``."""

    def __init__(self, cfg: TransformerConfig, num_classes: int = 2,
                 device=None, param_dtype=torch.float32):
        super().__init__()
        self.encoder = BertEncoder(cfg, device, param_dtype)
        device = self.encoder.device
        d = cfg.d_model
        self.pooler = Dense(d, d, True, cfg.dtype, param_dtype, device)
        self.classifier = Dense(d, num_classes, True, torch.float32,
                                param_dtype, device)

    def forward(self, tokens: torch.Tensor,
                attention_mask: torch.Tensor = None) -> torch.Tensor:
        h = self.encoder(tokens, attention_mask)
        cls = torch.tanh(self.pooler(h[:, 0]))
        return self.classifier(cls.to(torch.float32))


class BertMLM(nn.Module):
    """Masked-LM head: ``mlm_dense`` then tanh-approximate GELU (flax
    ``nn.gelu``), the ``mlm_ln`` RMSNorm, and ``mlm_out`` in fp32 (a plain
    vocabulary projection, not tied) -> fp32 logits ``[B, T, vocab]``."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.encoder = BertEncoder(cfg, device, param_dtype)
        device = self.encoder.device
        d = cfg.d_model
        self.mlm_dense = Dense(d, d, True, cfg.dtype, param_dtype, device)
        self.mlm_ln = RMSNorm(d, _FLAX_RMS_EPS, cfg.dtype, device)
        self.mlm_out = Dense(d, cfg.vocab_size, True, torch.float32,
                             param_dtype, device)

    def forward(self, tokens: torch.Tensor,
                attention_mask: torch.Tensor = None) -> torch.Tensor:
        h = self.encoder(tokens, attention_mask)
        h = self.mlm_ln(F.gelu(self.mlm_dense(h), approximate="tanh"))
        return self.mlm_out(h.to(torch.float32))
