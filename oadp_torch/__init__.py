"""OADP on PyTorch and CUDA: the port of ``oadp_tpu`` to one NVIDIA H100.

This slice holds the OAKE objects and globals pipelines. The three Pallas
kernels on that path are hand-written CUDA kernels for ``sm_90a``
(``csrc/``), built at first use; every kernel has a plain PyTorch version
beside it, which a tensor on the CPU takes. The package imports neither
``jax`` nor ``oadp_tpu``.
"""

__version__ = '0.1.0'
