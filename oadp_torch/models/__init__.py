"""CLIP image and text encoders, and the BPE tokenizer."""

from . import clip, tokenizer

__all__ = ['clip', 'tokenizer']
