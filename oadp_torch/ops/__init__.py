"""Preprocessing, box algebra and the fused attention kernels."""

from . import attention, boxes, preprocess

__all__ = ['attention', 'boxes', 'preprocess']
