"""CLIP image and text encoders, the BPE tokenizer, and the DP detector
stack (ResNet, FPN, RPN, RoI heads, mask head)."""

from . import clip, detector, fpn, heads, layers, mask_head, resnet, rpn, tokenizer

__all__ = ['clip', 'detector', 'fpn', 'heads', 'layers', 'mask_head', 'resnet', 'rpn',
           'tokenizer']
