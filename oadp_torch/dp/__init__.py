"""DP ("Distillation Pyramid") stage: the detector's assembly, data
pipeline, trainer, evaluation loop, the train and test CLIs, the
calibration trial and sweep CLIs (``test_calibrate``, ``calibrate_sweep``),
and the COCO and LVIS evaluators."""

from . import builder, coco_eval, datasets, evaluator, lvis_eval, synthetic, trainer

__all__ = ['builder', 'coco_eval', 'datasets', 'evaluator', 'lvis_eval', 'synthetic',
           'trainer']
