"""DP ("Distillation Pyramid") stage: so far the COCO and LVIS evaluators
(copies of ``oadp_tpu/dp/{coco_eval,lvis_eval}.py``)."""

from . import coco_eval, lvis_eval

__all__ = ['coco_eval', 'lvis_eval']
