"""Process-global environment flags.

Analogue of the reference's env-var flag system
(``todd.StoreMeta`` usage at reference ``oadp/base/globals_.py:14-16``).
Flags are read from the environment once at import; boolean flags accept
``1/true/yes`` (case-insensitive).

Flags:
    DRY_RUN: truncate datasets / shrink intervals for smoke tests
        (reference semantics: ``oadp/dp/datasets.py:29-63``,
        ``oadp/oake/objects.py:166-167``).
    CPU: force CPU execution (single process, no collectives).
    CUDA: set when a CUDA device is visible to torch (probed lazily).
    TRAIN_WITH_VAL_DATASET: substitute val dataset during training
        (reference ``oadp/dp/train.py:45-49``).
    DUMP: directory for per-image logit records during test
        (reference ``oadp/dp/roi_heads.py:131-166``); empty string = off.
    ODPS: Alibaba-cloud path shim flag (reference ``oadp/base/odps.py``).
"""

__all__ = ['Store']

import os


def _flag(name: str) -> bool:
    return os.environ.get(name, '').lower() in ('1', 'true', 'yes')


class _StoreMeta(type):

    @property
    def DRY_RUN(cls) -> bool:
        return _flag('DRY_RUN')

    @property
    def CPU(cls) -> bool:
        return _flag('CPU')

    @property
    def CUDA(cls) -> bool:
        if cls.CPU:
            return False
        return cls._backend() == 'cuda'

    @property
    def TRAIN_WITH_VAL_DATASET(cls) -> bool:
        return _flag('TRAIN_WITH_VAL_DATASET')

    @property
    def DUMP(cls) -> str:
        return os.environ.get('DUMP', '')

    @property
    def ODPS(cls) -> bool:
        return _flag('ODPS')

    _backend_cache: str | None = None

    def _backend(cls) -> str:
        if cls._backend_cache is None:
            import torch
            cls._backend_cache = (
                'cuda' if torch.cuda.is_available() else 'cpu'
            )
        return cls._backend_cache


class Store(metaclass=_StoreMeta):
    """Read-only view of process-global flags."""
