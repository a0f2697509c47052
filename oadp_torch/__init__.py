"""OADP on PyTorch and CUDA: the port of ``oadp_tpu`` to one NVIDIA H100.

It holds the OAKE objects, globals and blocks pipelines, the CLIP text
encoder with the ViLD and DetPro prompt builders, the DP detector's
trainer and test CLI, the calibration trial and sweep, the COCO and LVIS
evaluators, the dry-run entry (``entry.py``) and the framework-free
helpers they share. The five Pallas
kernels of ``oadp_tpu`` are hand-written CUDA kernels for ``sm_90a``
(``csrc/``), built at first use; every kernel has a plain PyTorch version
beside it, which a tensor on the CPU takes. The package imports neither
``jax`` nor ``oadp_tpu``.
"""

__version__ = '0.1.0'
