"""Process rank and world size for the OAKE per-rank interleave.

The reference initializes an NCCL process group at the top of every
entry point (``oadp/oake/base.py:122-126``); OAKE itself needs no
collectives, only each process's rank and the process count to shard
the image index space (``oadp_tpu/oake/base.py:153``). They come from
``torch.distributed`` when a process group is initialised, else from the
``RANK``/``WORLD_SIZE`` environment variables that ``torchrun`` sets,
else a single process (0 of 1).
"""

__all__ = ['rank', 'world_size']

import os

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    if _initialized():
        return dist.get_rank()
    return int(os.environ.get('RANK', 0))


def world_size() -> int:
    if _initialized():
        return dist.get_world_size()
    return int(os.environ.get('WORLD_SIZE', 1))
