"""The job of the OAKE objects mixes: the port's ``ObjectsPipeline.run_split``
(its producer thread, ``inflight`` batches on the device, its saver
thread) over a synthetic COCO-like split that outlasts the window
(``oake_runner``).

Traffic, from ``--seed`` and the mix's parameters: the JPEG pool of
``oake_runner.make_pool``, and for every image id its own ``proposals``
boxes: sides log-uniform from ``min_side`` to the whole image, positions
uniform, objectness uniform and sorted, as proposal files are; the
pipeline square-expands them by the mix's ``expand_mode``.

Afterwards ``check_records`` records written in the window, drawn from
the seed, are held to the plain reference.
"""

from __future__ import annotations

import math
import pathlib
import pickle

import numpy as np
import torch

from benchmark import harness
from benchmark.jobs import oake_runner as R
from benchmark.reference import clip_vit, precision
from benchmark.reference import objects as ref


def make_split(mix: dict, seed: int, root: pathlib.Path, device) -> dict:
    """The split's JPEG pool, COCO index and proposal file under ``root``."""
    split = R.make_pool(mix, seed, root, device)
    rng, n, p = split['rng'], len(split['ids']), int(mix['proposals'])
    wh = np.asarray(split['sizes'], np.float64)[split['image_of']]  # (n, 2)
    lo = math.log(mix['min_side'])
    side = np.exp(lo + rng.random((n, p, 2)) * (np.log(wh)[:, None, :] - lo))
    x0 = rng.random((n, p, 2)) * (wh[:, None, :] - side)
    score = -np.sort(-rng.random((n, p)), axis=1)
    split['proposals'] = np.concatenate([x0, x0 + side, score[..., None]], -1).astype(np.float32)
    split['proposal_file'] = root / 'proposals.pkl'
    with open(split['proposal_file'], 'wb') as f:
        pickle.dump(list(split['proposals']), f)  # in the order of the sorted ids
    return split


def run(spec: harness.Spec) -> harness.Outcome:
    from oadp_torch.oake.objects import ObjectsPipeline

    cfg, mix = spec.cell.config, spec.cell.mix
    device = torch.device(spec.device)
    dtype = getattr(torch, cfg['dtype']) if device.type == 'cuda' else torch.float32
    spans = harness.Spans()
    split = spans.timed('setup.split', make_split, mix, spec.seed, spec.tmp / 'split', device)
    params = spans.timed('setup.weights', clip_vit.random_params, cfg, spec.seed, device, dtype)
    model = spans.timed('setup.model', R.program_model, cfg, params, device, dtype)
    del params
    config = dict(model=dict(device=spec.device, max_image_size=cfg['max_image_size'],
                             checkpoint=None),
                  mini_batch_size=cfg['objects_mini_batch_size'],
                  batch_size=cfg['objects_batch_size'],
                  expand_mode=mix['expand_mode'], log=dict(interval=10 ** 9))
    dataset = dict(root=str(split['img_dir']), annFile=str(split['ann']),
                   proposal_file=str(split['proposal_file']), proposal_sorted=True)
    window, traced, peak = R.run_pipeline(
        spec, ObjectsPipeline, lambda prepared: sum(b for p in prepared for _, b, _ in p['chunks']),
        lambda record: len(record['embeddings']), model, config, dataset, spans)
    del model
    R.free()
    checks = check(spec, split, window.in_window, device, dtype)
    return R.outcome(window, spans, traced, peak, checks)


# ---------------------------------------------------------------------------
# Correctness
# ---------------------------------------------------------------------------


def reference_record(spec: harness.Spec, split: dict, id_: int, params: dict, device,
                     cast=precision.exact) -> dict:
    k = int(np.searchsorted(split['ids'], id_))
    return ref.embed_image(R.image(split, id_), split['proposals'][k], params, spec.cell.config,
                           spec.cell.mix['expand_mode'], device, cast)


def compare(got: dict, want: dict) -> dict[str, float]:
    """The numbers compared for one record: the widest gap between a
    crop's embedding and the reference's (L2, both unit vectors), the box
    and objectness values that differ, and rows missing or extra."""
    emb = torch.as_tensor(got['embeddings']).float()
    rows_missing = abs(len(emb) - len(want['embeddings']))
    n = min(len(emb), len(want['embeddings']))
    gap = torch.linalg.vector_norm(emb[:n] - want['embeddings'][:n], dim=-1)
    boxes = 0
    for key in ('bboxes', 'objectness'):
        a, b = np.asarray(got[key]), want[key]
        boxes += int((a != b).sum()) if a.shape == b.shape else b.size
    return dict(emb_gap_max=float(gap.max()) if n else math.inf, box_mismatch=boxes,
                rows_missing=rows_missing)


def _worst(pairs) -> dict[str, float]:
    worst: dict[str, float] = {}
    for got, want in pairs:
        for k, v in compare(got, want).items():
            worst[k] = max(worst.get(k, 0), v)
    return worst or dict(emb_gap_max=math.inf, box_mismatch=math.inf, rows_missing=math.inf)


def check(spec: harness.Spec, split: dict, in_window, device, dtype) -> dict[str, float]:
    """Hold the sampled records to the reference, computed in float32 from
    the program's weights made again from the seed."""
    params = clip_vit.random_params(spec.cell.config, spec.seed, device, dtype)
    return _worst(
        (torch.load(path, weights_only=False),
         reference_record(spec, split, int(pathlib.Path(path).stem), params, device))
        for path in R.sample(spec.seed, in_window, int(spec.cell.mix['check_records'])))


def control(spec: harness.Spec) -> dict[str, float]:
    """The control's numbers: the reference computed through fp8 in the
    program's place, held to the float32 reference on ``check_records``
    records of the seed's split (drawn from the seed)."""
    device = torch.device(spec.device)
    split = make_split(spec.cell.mix, spec.seed, spec.tmp / 'split', device)
    params = clip_vit.random_params(spec.cell.config, spec.seed, device,
                                    getattr(torch, spec.cell.config['dtype']))
    rng = np.random.default_rng([spec.seed, 2])

    def pair(id_):
        want = reference_record(spec, split, id_, params, device)
        got = reference_record(spec, split, id_, params, device, precision.fp8)
        return dict(got, embeddings=got['embeddings'].half()), want

    ids = rng.choice(split['ids'], int(spec.cell.mix['check_records']), replace=False)
    return _worst(pair(int(i)) for i in ids)
