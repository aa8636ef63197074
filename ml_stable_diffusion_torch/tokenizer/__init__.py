"""CLIP BPE tokenizer; the T5 unigram tokenizer is ``tokenizer/t5.py``."""

from .bpe import CLIPTokenizer

__all__ = ["CLIPTokenizer"]
