"""Preprocessing, box algebra, anchors, NMS, RoIAlign, polygon masks and
the fused attention kernels."""

from . import anchors, attention, boxes, coder, masks, nms, preprocess, roi_align

__all__ = ['anchors', 'attention', 'boxes', 'coder', 'masks', 'nms', 'preprocess',
           'roi_align']
