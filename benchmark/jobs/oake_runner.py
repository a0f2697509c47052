"""What the OAKE jobs share: the synthetic COCO-like JPEG pool, the
port's CLIP model built from the benchmark's weights, and one timed
``run_split`` of a port pipeline with the benchmark's spans around its
hooks.

The window opens when the ``warm_records``-th record is written (the
library built, every shape run, the pipeline full) and closes with the
first dispatch whose records are all written ``--seconds`` or more later,
so that it holds whole dispatches; the producer stops taking images at
``--seconds`` and the pipeline drains. Records go to a fresh directory
under the run's temporary directory.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import sys
import threading
import time
import unittest.mock

import numpy as np
import PIL.Image
import torch
import torch.nn.functional as F

from benchmark import harness


# ---------------------------------------------------------------------------
# Traffic
# ---------------------------------------------------------------------------


def _photo(gen: torch.Generator, w: int, h: int, device) -> np.ndarray:
    """A ``(h, w, 3)`` uint8 image: smooth colour fields at three scales
    and fine grain, which JPEG compresses about as it does a photo."""
    img = torch.full((1, 3, h, w), 128.0, device=device)
    for cells, amp in ((6, 90.0), (24, 45.0), (96, 28.0)):
        low = torch.randn((1, 3, max(2, h * cells // 640), max(2, w * cells // 640)),
                          generator=gen, device=device)
        img += amp * F.interpolate(low, size=(h, w), mode='bicubic', align_corners=False)
    img += 12.0 * torch.randn((1, 3, h, w), generator=gen, device=device)
    return img.clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0).contiguous().cpu().numpy()


def make_pool(mix: dict, seed: int, root: pathlib.Path, device) -> dict:
    """A JPEG for each of the mix's ``sizes`` (the same sizes for every
    seed, the content drawn from it) and ``ids`` image ids with their COCO
    index. The OAKE runner takes ids by size (``oadp_torch/oake/base.py:
    _items``), so they are laid out in that order: ``ids_each`` for every
    JPEG, and the rest over the JPEGs of the size it takes last. A window
    reads every size before it reaches the rest, and a faster program
    reads further into it; every seed has the same sizes in the same order."""
    rng = np.random.default_rng([seed, 0])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    img_dir = root / 'images'
    img_dir.mkdir(parents=True)
    sizes = [tuple(s) for s in mix['sizes']]
    files = []
    for i, (w, h) in enumerate(sizes):
        name = f'pool_{i:03d}.jpg'
        buf = io.BytesIO()
        PIL.Image.fromarray(_photo(gen, w, h, device)).save(buf, 'JPEG',
                                                             quality=mix['jpeg_quality'])
        (img_dir / name).write_bytes(buf.getvalue())
        files.append(name)
    order = sorted(range(len(sizes)), key=lambda k: (*sizes[k], k))
    last = [k for k in order if sizes[k] == sizes[order[-1]]]
    each = int(mix['ids_each'])
    lead = [k for k in order if k not in last for _ in range(each)]
    n = int(mix['ids'])
    if n <= len(lead):
        raise ValueError(f'ids ({n}) leave none for the last size after {len(lead)}')
    image_of = np.asarray(lead + [last[i % len(last)] for i in range(n - len(lead))])
    ids = np.arange(1, n + 1)
    ann = root / 'instances.json'
    ann.write_text(json.dumps(dict(images=[
        dict(id=int(i), file_name=files[k], width=sizes[k][0], height=sizes[k][1])
        for i, k in zip(ids, image_of)], annotations=[], categories=[])))
    return dict(img_dir=img_dir, ann=ann, image_of=image_of, files=files, ids=ids,
                sizes=sizes, rng=rng)


def image(split: dict, id_: int) -> PIL.Image.Image:
    k = int(np.searchsorted(split['ids'], id_))
    return PIL.Image.open(split['img_dir'] / split['files'][split['image_of'][k]]).convert('RGB')


def sample(seed: int, records: list[tuple[float, str, int]], k: int) -> list[str]:
    """``k`` record paths drawn from the seed among ``records``."""
    paths = sorted(p for _, p, _ in records)
    rng = np.random.default_rng([seed, 1])
    k = min(k, len(paths))
    return [paths[i] for i in sorted(rng.choice(len(paths), k, replace=False))]


# ---------------------------------------------------------------------------
# The system under test
# ---------------------------------------------------------------------------


def program_model(config: dict, params: dict, device: torch.device, dtype: torch.dtype):
    """The port's CLIP model built from the benchmark's weights, as
    ``oadp_torch.oake.encoders.load_clip`` builds it from a checkpoint."""
    from oadp_torch.models import clip as C
    from oadp_torch.oake.encoders import ClipModel

    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    vit = C.ViTConfig(image_size=config['image_size'], patch_size=config['patch_size'],
                      stride=config['patch_size'], width=config['width'],
                      layers=config['layers'], heads=config['heads'],
                      output_dim=config['output_dim'])
    surgery, surgery_config = C.upsample_vit_params(
        params, vit, config['patch_size'] // config['surgery_stride'])

    def prepared(p):
        return C.prepare_kernel_params(p) if device.type == 'cuda' else p

    return ClipModel(prepared(params), vit, prepared(surgery), surgery_config, device, dtype)


class Window:
    """The window's state, shared by the pipeline's threads: it opens at
    the ``warm``-th record written and closes at the first record written
    ``seconds`` or more later that ends a dispatch of ``batch`` records."""

    def __init__(self, spans: harness.Spans, warm: int, seconds: float, batch: int) -> None:
        self.spans, self.warm, self.seconds, self.batch = spans, warm, seconds, batch
        self.open = self.close = self.due = None
        self.saves: list[tuple[float, str, int]] = []  # (end, path, rows)
        self.yielded = 0
        self.stopped = False
        self.dispatches = self.dispatch_rows = 0
        self.notes: dict = {}
        self._lock = threading.Lock()

    def saved(self, path: str, rows: int, t: float) -> None:
        with self._lock:
            self.saves.append((t, path, rows))
            n = len(self.saves)
            if n == self.warm:
                self.open, self.due = t, t + self.seconds
            elif (self.due is not None and self.close is None and t >= self.due
                  and (n - self.warm) % self.batch == 0):
                self.close = t

    def closed(self) -> bool:
        """Whether the producer should stop: ``seconds`` have passed."""
        return self.due is not None and time.perf_counter() >= self.due

    @property
    def in_window(self) -> list[tuple[float, str, int]]:
        return [s for s in self.saves if self.open < s[0] <= self.close]


def hooked(pipeline_cls, rows_of_prepared):
    """``pipeline_cls`` with the benchmark's spans around its hooks; its
    producer stops once the window's ``seconds`` have passed."""

    class Pipeline(pipeline_cls):
        window: Window

        def build_dataset(self, cfg):
            dataset = super().build_dataset(cfg)
            load = dataset.load
            dataset.load = lambda id_: self.window.spans.timed('oake.decode', load, id_)
            return dataset

        def _items(self, *args, **kwargs):
            for item in super()._items(*args, **kwargs):
                if self.window.closed():
                    self.window.stopped = True
                    return
                self.window.yielded += 1
                yield item

        def prepare(self, item):
            return self.window.spans.timed('oake.prepare', super().prepare, item)

        def execute_batch(self, prepared):
            out = self.window.spans.timed('oake.dispatch', super().execute_batch, prepared)
            self.window.dispatches += 1
            self.window.dispatch_rows += rows_of_prepared(prepared)
            return out

        def finalize(self, record):
            return self.window.spans.timed('oake.fetch', super().finalize, record)

    return Pipeline


def run_pipeline(spec: harness.Spec, pipeline_cls, rows_of_prepared, rows_of_record,
                 model, config: dict, dataset: dict, spans: harness.Spans):
    """One timed ``run_split`` of ``pipeline_cls`` (a port pipeline) over
    ``dataset`` with ``model``; returns the window, the trace of the
    traced run (None otherwise) and the device's peak memory. The pipeline
    is dropped before it returns; the caller frees ``model``."""
    from oadp_torch.oake import base as oake_base
    from oadp_torch.utils import Config, save_pth

    from benchmark import trace as T

    config = Config.merge(Config(), config)
    with unittest.mock.patch.object(oake_base, 'load_clip', lambda *a, **k: model):
        pipeline = spans.timed('setup.pipeline', hooked(pipeline_cls, rows_of_prepared),
                               'benchmark', config)
    window = pipeline.window = Window(spans, int(spec.cell.mix['warm_records']), spec.seconds,
                                      pipeline.device_batch)

    def save(record, path):
        t0 = time.perf_counter()
        save_pth(record, path)
        t1 = time.perf_counter()
        spans.add('oake.save', t0, t1)
        window.saved(str(path), rows_of_record(record), t1)

    split_cfg = Config.merge(Config(), dict(dataloader=dict(dataset=dict(
        dataset, type='COCODataset', output_dir=str(spec.tmp / 'records')))))
    cuda = torch.device(spec.device).type == 'cuda'
    session = T.Session().start() if spec.trace else None
    with contextlib.ExitStack() as stack:
        smi = stack.enter_context(T.Smi()) if spec.trace and cuda else None
        stack.enter_context(unittest.mock.patch.object(oake_base, 'save_pth', save))
        pipeline.run_split(split_cfg)
    traced = session.stop(spec.tmp / 'trace.json') if session else None
    if not window.stopped or window.close is None:
        raise harness.BenchmarkError(
            f'the split ran out before the window closed ({len(window.saves)} records): '
            'give the mix more ids')
    if traced is not None:
        traced.spans = spans
        window.notes = dict(nvidia_smi=smi.samples if smi else None,
                            window=[window.open, window.close], launches=traced.launches)
    first = min(t0 for t0, _ in spans.by_name['oake.dispatch'])
    print(json.dumps(dict(setup={k: v[0][1] - v[0][0] for k, v in spans.by_name.items()
                                 if k.startswith('setup.')},
                          first_dispatch_to_open=window.open - first)), file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del pipeline
    return window, traced, memory_peak


def outcome(window: Window, spans: harness.Spans, traced, memory_peak: int,
            checks: dict) -> harness.Outcome:
    in_window = window.in_window
    return harness.Outcome(
        window=(window.open, window.close), spans=spans,
        counts=dict(records_in_window=len(in_window),
                    crops_in_window=sum(rows for _, _, rows in in_window),
                    dispatches=window.dispatches, dispatch_rows=window.dispatch_rows),
        checks=checks, attempted=window.yielded, failed=window.yielded - len(window.saves),
        memory_peak_bytes=memory_peak, trace=traced, notes=window.notes)


def free() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
