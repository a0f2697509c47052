"""``.pth``-compatible feature-file I/O.

The reference stores one feature file per image via ``torch.save``
(``oadp/oake/base.py:106-113``; layout ``{id:012d}.pth`` at
``oadp/oake/base.py:44``) and reads them back in the DP input pipeline
(``oadp/dp/datasets.py:171-175``). A copy of ``oadp_tpu/utils/pth.py``:
records cross this boundary as numpy arrays, so the files are
byte-compatible with the ones ``oadp_tpu`` writes.
"""

__all__ = ['save_pth', 'load_pth', 'PthAccessLayer']

import os
import pathlib
from typing import Any, Iterator, Mapping

import numpy as np


def _to_torch(value: Any):
    import torch
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value))
    if isinstance(value, dict):
        return {k: _to_torch(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_torch(v) for v in value)
    return value


def _to_numpy(value: Any):
    import torch
    if isinstance(value, torch.Tensor):
        return value.numpy()
    if isinstance(value, dict):
        return {k: _to_numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_numpy(v) for v in value)
    return value


def save_pth(obj: Any, path: str | pathlib.Path) -> None:
    """Atomically write ``obj`` (numpy arrays become torch tensors).

    The temp name is unique per writer PROCESS: in multi-process DUMP
    mode the loader's batch-count padding can hand the same image to two
    ranks, and a shared fixed ``.tmp`` path would let their writes
    interleave before the rename — with per-pid temps the last atomic
    ``os.replace`` wins and the published file is always intact.
    """
    import torch
    path = pathlib.Path(path)
    tmp = path.with_name(f'{path.name}.{os.getpid()}.tmp')
    torch.save(_to_torch(obj), tmp)
    os.replace(tmp, path)


def load_pth(path: str | pathlib.Path) -> Any:
    import torch
    return _to_numpy(torch.load(path, map_location='cpu', weights_only=False))


class PthAccessLayer(Mapping[str, Any]):
    """Key → ``{data_root}/{task_name}/{key}.pth`` mapping (analogue of
    ``todd.datasets.PthAccessLayer``, used at reference
    ``oadp/dp/datasets.py:153-161`` and ``oadp/dp/roi_heads.py:131-135``)."""

    def __init__(
        self,
        data_root: str,
        task_name: str = '',
        readonly: bool = True,
    ) -> None:
        self._root = pathlib.Path(data_root) / task_name
        if not readonly:
            self._root.mkdir(parents=True, exist_ok=True)

    def __getitem__(self, key: str) -> Any:
        return load_pth(self._root / f'{key}.pth')

    def __setitem__(self, key: str, value: Any) -> None:
        save_pth(value, self._root / f'{key}.pth')

    def __contains__(self, key: object) -> bool:
        return (self._root / f'{key}.pth').exists()

    def __iter__(self) -> Iterator[str]:
        return (p.stem for p in sorted(self._root.glob('*.pth')))

    def __len__(self) -> int:
        return sum(1 for _ in self)
