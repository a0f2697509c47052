"""Repackage DetPro LVIS prompt embeddings:
``python -m oadp_torch.prompts.detpro`` (reference
``oadp/prompts/detpro.py``), a copy of ``oadp_tpu/prompts/detpro.py``.

DetPro's ``iou_neg5_ens.pth`` rows follow the original LVIS category-id
order; names are read from an LVIS annotation file so they match the
annotation spelling (including the ``stero_equipment`` typo the
reference restores at ``:11-14``).
"""

__all__ = ['main']

import argparse
import json
import pathlib

import numpy as np

from ..utils import load_pth, logger, save_pth


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        '--embeddings', default='pretrained/detpro/iou_neg5_ens.pth'
    )
    parser.add_argument(
        '--ann-file', default='data/lvis_v1/annotations/lvis_v1_val.json'
    )
    parser.add_argument('--output', default='data/prompts/detpro_lvis.pth')
    args = parser.parse_args(argv)

    embeddings = np.asarray(load_pth(args.embeddings), np.float32)
    with open(args.ann_file) as f:
        cats = json.load(f)['categories']
    names = [c['name'] for c in sorted(cats, key=lambda c: c['id'])]
    assert len(names) == embeddings.shape[0], (
        len(names), embeddings.shape
    )
    pathlib.Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    save_pth(dict(names=names, embeddings=embeddings), args.output)
    logger.info('saved %s (%d names)', args.output, len(names))


if __name__ == '__main__':
    main()
