"""OAKE: offline CLIP knowledge extraction (globals and objects).

Submodules are CLI entry points (``python -m oadp_torch.oake.<task>``) and
are intentionally not imported here to keep ``runpy`` clean.
"""

from .encoders import ClipModel, OakeSteps, load_clip

__all__ = ['ClipModel', 'OakeSteps', 'load_clip']
