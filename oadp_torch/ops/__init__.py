"""Preprocessing, box algebra, polygon masks and the fused attention
kernels."""

from . import attention, boxes, masks, preprocess

__all__ = ['attention', 'boxes', 'masks', 'preprocess']
