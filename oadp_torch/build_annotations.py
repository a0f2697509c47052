"""Build OV annotation splits: ``python -m oadp_torch.build_annotations``.

A copy of ``oadp_tpu/build_annotations.py``. Reimplements reference
``oadp/build_annotations.py`` without the
pycocotools/lvis C extensions (plain JSON):

* category ids are remapped to the base-first contiguous order of
  ``categories.all_`` (``:54-58``);
* dumps ``.{num_all}`` (all classes), ``.{num_bases}`` (annotations
  filtered to bases), and optionally ``.min`` (images without
  annotations dropped) (``:50-68``);
* LVIS also remaps ``neg_category_ids`` / ``not_exhaustive_category_ids``
  (``:99-108``).
"""

__all__ = ['Builder', 'COCOBuilder', 'LVISBuilder', 'main']

import json
import pathlib
from typing import Any

from .base import Categories, coco, lvis
from .utils import logger

Data = dict[str, Any]


class Builder:

    def __init__(self, categories: Categories, root: str) -> None:
        self._categories = categories
        self._root = pathlib.Path(root)

    def _load(self, file: pathlib.Path) -> Data:
        with file.open() as f:
            data = json.load(f)
        names = set(self._categories.all_)
        cats = [c for c in data['categories'] if c['name'] in names]
        cat_ids = {c['id'] for c in cats}
        anns = [
            a for a in data['annotations'] if a['category_id'] in cat_ids
        ]
        return dict(
            categories=cats, annotations=anns, images=data['images']
        )

    def _map_cat_ids(self, data: Data, oid2nid: dict[int, int]) -> None:
        for cat in data['categories']:
            cat['id'] = oid2nid[cat['id']]
        for ann in data['annotations']:
            ann['category_id'] = oid2nid[ann['category_id']]

    def _dump(self, data: Data, file: pathlib.Path, suffix: str) -> None:
        out = file.with_name(f'{file.stem}.{suffix}{file.suffix}')
        logger.info('dumping %s', out)
        with out.open('w') as f:
            json.dump(data, f, separators=(',', ':'))

    def build(self, filename: str, min: bool = False) -> None:
        file = self._root / filename
        data = self._load(file)
        oid2nid = {
            cat['id']: self._categories.all_.index(cat['name'])
            for cat in data['categories']
        }
        self._map_cat_ids(data, oid2nid)
        data['categories'] = sorted(
            data['categories'], key=lambda cat: cat['id']
        )
        self._dump(data, file, str(self._categories.num_all))
        anns = [
            a for a in data['annotations']
            if a['category_id'] < self._categories.num_bases
        ]
        self._dump(data | dict(annotations=anns), file,
                   str(self._categories.num_bases))
        if min:
            img_ids = {a['image_id'] for a in data['annotations']}
            imgs = [i for i in data['images'] if i['id'] in img_ids]
            self._dump(data | dict(images=imgs), file,
                       f'{self._categories.num_all}.min')


class COCOBuilder(Builder):

    def __init__(self, root: str = 'data/coco/annotations') -> None:
        super().__init__(coco, root)


class LVISBuilder(Builder):

    def __init__(self, root: str = 'data/lvis_v1/annotations') -> None:
        super().__init__(lvis, root)

    def _map_cat_ids(self, data: Data, oid2nid: dict[int, int]) -> None:
        super()._map_cat_ids(data, oid2nid)
        for img in data['images']:
            for key in ('neg_category_ids', 'not_exhaustive_category_ids'):
                if key in img:
                    img[key] = [oid2nid[c] for c in img[key]]


def main() -> None:
    coco_builder = COCOBuilder()
    coco_builder.build('instances_val2017.json', min=True)
    coco_builder.build('instances_train2017.json')

    lvis_builder = LVISBuilder()
    lvis_builder.build('lvis_v1_val.json')
    lvis_builder.build('lvis_v1_train.json')


if __name__ == '__main__':
    main()
