"""Alibaba-cloud (ODPS) path shim (reference ``oadp/base/odps.py``), a
copy of ``oadp_tpu/base/odps.py``.

Symlinks the ODPS OSS bucket mounts into the working directory so the
relative ``data/ pretrained/ work_dirs/`` layout keeps working on that
platform. Activated by the ``ODPS`` env flag.
"""

__all__ = ['odps_init', 'ODPS_PATHS']

import os
from typing import Mapping

from ..utils import logger

ODPS_PATHS = dict(
    data='/data/oss_bucket_0',
    pretrained='/data/oss_bucket_0/ckpts',
    work_dirs='/data/oss_bucket_0/work_dirs',
)


def odps_init(kwargs: Mapping[str, str] | None = None) -> None:
    os.environ['ODPS'] = '1'
    os.environ.update(dict(kwargs or {}))
    for name, target in ODPS_PATHS.items():
        if not os.path.lexists(name):
            os.symlink(target, name)
    logger.debug('ODPS initialized with %s', os.listdir('.'))
