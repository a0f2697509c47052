"""DP ("Distillation Pyramid") stage: the detector's assembly, data
pipeline, evaluation loop and test CLI, and the COCO and LVIS evaluators."""

from . import builder, coco_eval, datasets, evaluator, lvis_eval

__all__ = ['builder', 'coco_eval', 'datasets', 'evaluator', 'lvis_eval']
