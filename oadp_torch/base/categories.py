"""Category taxonomy: base/novel class-name splits for OV-COCO and OV-LVIS.

The splits are dataset facts (48 base + 17 novel for COCO, 866 + 337 for
LVIS) stored as JSON under ``oadp_torch/base/data/`` (copies of
``oadp_tpu``'s); accessors mirror the reference's ``Categories``
(``oadp/base/globals_.py:19-47``) so that category order — bases first,
then novels — matches the annotation files produced by
``build_annotations``.
"""

__all__ = ['Categories', 'coco', 'lvis', 'Globals']

import functools
import json
import pathlib
from typing import Iterable

_DATA = pathlib.Path(__file__).parent / 'data'


class Categories:

    def __init__(self, bases: Iterable[str], novels: Iterable[str]) -> None:
        self._bases = tuple(bases)
        self._novels = tuple(novels)

    @property
    def bases(self) -> tuple[str, ...]:
        return self._bases

    @property
    def novels(self) -> tuple[str, ...]:
        return self._novels

    @property
    def all_(self) -> tuple[str, ...]:
        return self._bases + self._novels

    @property
    def num_bases(self) -> int:
        return len(self._bases)

    @property
    def num_novels(self) -> int:
        return len(self._novels)

    @property
    def num_all(self) -> int:
        return len(self.all_)


@functools.cache
def _load(name: str) -> Categories:
    data = json.loads((_DATA / f'{name}.json').read_text())
    return Categories(data['bases'], data['novels'])


class _Lazy:

    def __init__(self, name: str) -> None:
        self._name = name

    def __getattr__(self, attr: str):
        return getattr(_load(self._name), attr)


coco: Categories = _Lazy('coco')  # type: ignore[assignment]
lvis: Categories = _Lazy('lvis')  # type: ignore[assignment]


class Globals:
    """Process-global training state (reference ``oadp/base/globals_.py:50-56``).

    ``categories`` is set by the CLI from the config's ``categories`` string;
    ``training`` toggles train/inference behavior inside classifier heads.
    """
    categories: Categories
    training: bool = False
