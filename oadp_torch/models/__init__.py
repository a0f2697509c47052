"""CLIP image encoders."""

from . import clip

__all__ = ['clip']
