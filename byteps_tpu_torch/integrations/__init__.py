"""Drop-in integrations for third-party model libraries — the port of
``byteps_tpu/integrations``: HF GPT-2 and LLaMA weights onto the port's
``Transformer`` (``gpt2``, ``llama``), and HF torch BERT's
self-attention through the port's flash kernels (``hf_flash``).  None of
them imports ``transformers`` at import time; ``hf_flash`` imports it when
its context is entered."""

from .hf_flash import flash_attention_for_hf_bert  # noqa: F401

__all__ = ["flash_attention_for_hf_bert"]


def __getattr__(name):
    # the gpt2 converter loads on first use, as in the JAX package
    if name in ("gpt2_config", "convert_gpt2_state_dict", "load_gpt2"):
        from . import gpt2

        return getattr(gpt2, name)
    raise AttributeError(name)
