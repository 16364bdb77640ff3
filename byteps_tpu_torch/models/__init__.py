"""The decoder-only Transformer, the BERT encoder and its heads, and the
JAX-parameter converter."""

from .bert import BertClassifier, BertEncoder, BertMLM, bert_config

__all__ = ["BertEncoder", "BertClassifier", "BertMLM", "bert_config"]
