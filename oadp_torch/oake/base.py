"""OAKE pipeline scaffold: dataset, sharded resumable runner, CLI
(port of ``oadp_tpu/oake/base.py``; reference ``oadp/oake/base.py``):

* images are sharded across processes by index interleaving (rank and
  world size from ``utils/dist.py``) — OAKE needs zero collectives; the
  filesystem is the only sync point (SURVEY.md §2c);
* the resume contract is identical: one ``{id:012d}.pth`` per image,
  skip-if-exists, ``auto_fix`` probes and regenerates corrupt files
  (reference ``oadp/oake/base.py:42-54``);
* host work (JPEG decode + resample-weight building) overlaps device
  compute through a small prefetch window, and each batch's embeddings
  are fetched one batch later: each dispatch queues its copy back to the
  host behind its own last kernel (:class:`HostCopy`), and the fetch
  waits for that copy alone, so the next dispatch stays queued;
* ``val`` runs first, then ``train`` (reference ``base.py:136-152``);
* ``profile='<dir>'`` traces each split with ``torch.profiler`` (host and,
  on a card, device activity) into a TensorBoard trace file in ``<dir>``,
  where ``oadp_tpu`` writes a ``jax.profiler`` trace;
* while any profiler session is open, the runner's three threads record
  spans (``utils/tracing.py``): the producer's ``runner.decode`` and
  ``runner.prepare`` an image, the saver's ``runner.write`` a record, the
  main thread's ``runner.wait_prepared`` an image and ``runner.fetch`` and
  ``runner.wait_saver`` a dispatch (the steps add ``step.stage`` and
  ``step.launch``); ``profile=`` writes them into its trace file. Each
  ``runner.fetch`` counts ``fetches`` and ``fetches_ahead``, the fetches
  after which the next dispatch's copy had not yet arrived.

The entry points run on ``model.device`` (default ``'cuda'``; a run
without a CUDA device raises unless it asks for ``'cpu'``). ``model.dtype``
defaults to ``bfloat16`` on CUDA and ``float32`` on the CPU.
"""

__all__ = ['CocoImageSet', 'BaseOakePipeline', 'HostCopy', 'bucket']

import argparse
import itertools
import json
import os
import pathlib
import queue as queue_mod
import socket
import threading
import time
from abc import ABC, abstractmethod
from typing import Any, Iterator

import numpy as np
import PIL.Image
import torch

from ..utils import (
    Config,
    DictAction,
    Store,
    load_pth,
    logger,
    rank,
    save_pth,
    tracing,
    world_size,
)
from .encoders import ClipModel, OakeSteps, load_clip, resolve_device

BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


def bucket(n: int, buckets: tuple[int, ...] = BUCKETS) -> int:
    """Smallest bucket ≥ n (a handful of batch shapes per run)."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


class HostCopy:
    """A device tensor's copy to the host, queued when made: on a card a
    ``non_blocking`` copy into page-locked memory on the current stream,
    behind the work queued so far, and an event after it; on the CPU the
    tensor itself. :meth:`wait` waits for that event alone, not for the
    stream or the device, so the work queued after it keeps running.
    CUDA's host pool takes the page-locked block back once its copy has
    run; only a block it has to create anew (the first dispatches' ones)
    waits for the device."""

    __slots__ = ('host', 'event')

    def __init__(self, tensor: torch.Tensor) -> None:
        self.event = None
        if tensor.device.type != 'cuda':
            self.host = tensor
            return
        self.host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        self.host.copy_(tensor, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(tensor.device))

    def ready(self) -> bool:
        """Whether the copy has arrived (never waits)."""
        return self.event is None or self.event.query()

    def wait(self) -> torch.Tensor:
        """The host tensor, once the copy has arrived."""
        if self.event is not None:
            self.event.synchronize()
        return self.host


def _host_copies(record: Any) -> Iterator[HostCopy]:
    """The :class:`HostCopy` objects a record holds, in its dicts, lists
    and tuples."""
    if isinstance(record, HostCopy):
        yield record
    elif isinstance(record, dict):
        for value in record.values():
            yield from _host_copies(value)
    elif isinstance(record, (list, tuple)):
        for value in record:
            yield from _host_copies(value)


class CocoImageSet:
    """Minimal COCO/LVIS image index (replaces torchvision CocoDetection
    as used at reference ``oadp/oake/base.py:28``)."""

    def __init__(self, root: str, ann_file: str, lvis: bool = False) -> None:
        self.root = pathlib.Path(root)
        self._lvis = lvis
        with open(ann_file) as f:
            data = json.load(f)
        self._images = {img['id']: img for img in data['images']}
        # torchvision CocoDetection sorts ids
        self.ids: list[int] = sorted(self._images)
        self.unsorted_ids: list[int] = [img['id'] for img in data['images']]

    def size(self, id_: int) -> tuple[int, int]:
        """(width, height) from the annotation index — no decode."""
        info = self._images[id_]
        return int(info['width']), int(info['height'])

    def path(self, id_: int) -> pathlib.Path:
        info = self._images[id_]
        if self._lvis:
            # LVIS images live in the COCO tree; resolve via coco_url
            # (reference ``oadp/oake/objects.py:192-195``)
            rel = info['coco_url'].replace(
                'http://images.cocodataset.org/', ''
            )
            return self.root / rel
        return self.root / info['file_name']

    def load(self, id_: int) -> np.ndarray:
        with PIL.Image.open(self.path(id_)) as img:
            return np.asarray(img.convert('RGB'))


class BaseOakePipeline(ABC):
    """One OAKE extraction task (globals / blocks / objects)."""

    def __init__(self, name: str, config: Config) -> None:
        self.name = name
        self.config = config
        model_cfg = config.get('model', Config())
        self.pad = int(model_cfg.get('max_image_size', 640))
        device = resolve_device(model_cfg.get('device', 'cuda'))
        self.model: ClipModel = load_clip(
            model_cfg.get('checkpoint', 'pretrained/clip/ViT-B-32.pt'),
            model_cfg.get(
                'dtype', 'bfloat16' if device.type == 'cuda' else 'float32'
            ),
            vit=model_cfg.get('vit'),
            device=device,
        )
        self.device = device
        self.steps = OakeSteps(self.model, self.pad, self.pad)
        self.log_interval = int(config.get('log', {}).get('interval', 50))

    # -- hooks ------------------------------------------------------------

    @abstractmethod
    def prepare(self, item: dict[str, Any]) -> dict[str, Any] | None:
        """Host-side prep: decode outputs → device inputs (numpy)."""

    #: number of prepared items executed per device call (pipelines with
    #: per-image programs keep 1; globals batches across images)
    device_batch: int = 1

    @abstractmethod
    def execute_batch(
        self, prepared: list[dict[str, Any]]
    ) -> list[Any]:
        """Queue the device step(s) on ≤ ``device_batch`` prepared items,
        each output's copy back to the host right behind them
        (:class:`HostCopy`), and return one record per item (saved to its
        ``output`` path) holding those copies, not device tensors. Records
        are finalized one batch later (:meth:`finalize`), so device
        compute overlaps the previous batch's fetch and disk write."""

    def finalize(self, record: Any) -> Any:
        """Materialize a record to numpy right before saving, waiting for
        its own dispatch's copies alone (:meth:`HostCopy.wait`)."""
        return record

    def build_dataset(self, dataset_cfg: Config) -> CocoImageSet:
        return CocoImageSet(
            dataset_cfg.root,
            dataset_cfg.annFile,
            lvis=dataset_cfg.get('type') == 'LVISDataset',
        )

    def dataset_kwargs(self, dataset_cfg: Config) -> dict[str, Any]:
        return {}

    # -- runner -----------------------------------------------------------

    def _pad_image(self, image: np.ndarray) -> np.ndarray:
        h, w = image.shape[:2]
        if h > self.pad or w > self.pad:
            raise ValueError(
                f'image {w}x{h} exceeds max_image_size={self.pad}; '
                f'override .model.max_image_size'
            )
        out = np.zeros((self.pad, self.pad, 3), np.uint8)
        out[:h, :w] = image
        return out

    def _items(
        self,
        dataset: CocoImageSet,
        output_dir: pathlib.Path,
        auto_fix: bool,
        extra: dict[str, Any],
    ) -> Iterator[tuple[int, dict[str, Any] | None]]:
        """``(image id, prepared item or None)`` for every image left to do."""
        ids = dataset.ids
        if Store.DRY_RUN:
            ids = ids[:3]
        ids = ids[rank()::world_size()]
        # Group this process's shard by image size (stable, id-tiebroken):
        # outputs are per-image files so order is free, and size-grouping
        # makes per-size device constants (blocks' pyramid matrices,
        # ~20 MB per distinct size) LRU-perfect and device batches
        # homogeneous. The reference iterates dataset order
        # (oadp/oake/base.py:84-88) but its outputs are order-free too.
        ids = sorted(ids, key=lambda i: (*dataset.size(i), i))
        for id_ in ids:
            output = output_dir / f'{id_:012d}.pth'
            if output.exists():
                if not auto_fix:
                    continue
                try:
                    load_pth(output)
                    continue
                except Exception:
                    logger.info('Fixing %s', output)
            with tracing.span('runner.decode', key=id_):
                image = dataset.load(id_)
            with tracing.span('runner.prepare', key=id_):
                prepared = self.prepare(
                    dict(
                        id=id_,
                        output=output,
                        image=image,
                        width=image.shape[1],
                        height=image.shape[0],
                        **extra,
                    )
                )
            yield id_, prepared

    def run_split(self, split_config: Config) -> None:
        dl = split_config.dataloader
        ds_cfg = dl.dataset
        dataset = self.build_dataset(ds_cfg)
        output_dir = pathlib.Path(ds_cfg.output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        extra = self.dataset_kwargs(ds_cfg)
        auto_fix = bool(ds_cfg.get('auto_fix', False))

        items = self._items(dataset, output_dir, auto_fix, extra)
        start = time.time()
        done = 0

        # Optional torch.profiler trace (config: profile='trace_dir'), the
        # counterpart of oadp_tpu's jax.profiler trace; the reference has no
        # tracing at all.
        profiling = self._start_profiler(self.config.get('profile'))

        # Bounded prefetch: one producer thread runs host prep (JPEG
        # decode + weight building, all GIL-releasing C/numpy) while the
        # main thread drives the device.
        sentinel = object()
        queue: 'queue_mod.Queue' = queue_mod.Queue(maxsize=4)

        def produce():
            try:
                for prepared in items:
                    queue.put(prepared)
            except BaseException as e:  # surfaced by the consumer
                queue.put(e)
            finally:
                queue.put(sentinel)

        producer = threading.Thread(target=produce, name='producer', daemon=True)
        producer.start()
        buffer: list[tuple[int, dict[str, Any]]] = []  # (image id, prepared)

        # Pipelining: the main thread queues batch k on the device, THEN
        # fetches batch k-1 (``finalize``). The fetch waits for k-1's own
        # copies back, queued behind k-1's last kernel, so it returns when
        # k-1 ends, with k still queued: the main thread stages and
        # launches k+1 while k runs. The saver thread only writes
        # finalized numpy records to disk.
        inflight = max(1, int(self.config.get('inflight', 2)))
        save_queue: 'queue_mod.Queue' = queue_mod.Queue(maxsize=inflight)
        save_error: list[BaseException] = []

        def save_loop():
            nonlocal done
            while True:
                entry = save_queue.get()
                if entry is sentinel:
                    return
                try:
                    batch, records = entry
                    for (id_, item), record in zip(batch, records):
                        with tracing.span('runner.write', key=id_):
                            save_pth(record, item['output'])
                    done += len(batch)
                    if done % self.log_interval < self.device_batch:
                        rate = done / (time.time() - start)
                        logger.info(
                            '[%s] %d images, %.2f img/s',
                            self.name, done, rate,
                        )
                except BaseException as e:
                    save_error.append(e)
                    return

        saver = threading.Thread(target=save_loop, name='saver', daemon=True)
        saver.start()

        def enqueue_save(entry, key=None):
            # never block forever on a saver that died: surface its
            # exception instead
            with tracing.span('runner.wait_saver', key=key):
                while True:
                    if save_error:
                        raise save_error[0]
                    try:
                        save_queue.put(entry, timeout=5)
                        return
                    except queue_mod.Full:
                        continue

        dispatches = itertools.count()
        pending: list = []  # [(dispatch, batch, raw records)] not fetched
        # fetches, and those after which the next dispatch's copies had not
        # arrived: the card still had work queued when the fetch returned
        fetched = dict(fetches=0, fetches_ahead=0)

        def fetch():
            n, batch, records = pending.pop(0)
            with tracing.span('runner.fetch', key=n, counters=fetched.copy):
                records = [self.finalize(r) for r in records]
                fetched['fetches'] += 1
                if pending and not all(c.ready() for c in _host_copies(pending[0][2])):
                    fetched['fetches_ahead'] += 1
            enqueue_save((batch, records), n)

        def flush():
            if not buffer:
                return
            n = next(dispatches)
            batch = list(buffer)
            buffer.clear()
            ids, items = zip(*batch)
            with tracing.serving(n, ids):
                records = self.execute_batch(list(items))  # queued, not waited on
            pending.append((n, batch, records))
            if len(pending) > 1:  # fetch the PREVIOUS batch
                fetch()

        # On any exception below, the daemon threads are simply
        # abandoned (the producer may be blocked on a full queue —
        # joining it would hang); the joins run only on the clean path.
        while True:
            with tracing.span('runner.wait_prepared') as waited:
                got = queue.get()
                if isinstance(got, tuple):
                    waited.key = got[0]
            if got is sentinel:
                break
            if isinstance(got, BaseException):
                raise got
            if got[1] is None:
                continue
            buffer.append(got)
            if len(buffer) >= self.device_batch:
                flush()
        flush()
        if pending:
            fetch()
        enqueue_save(sentinel)
        saver.join()
        producer.join()
        if save_error:
            raise save_error[0]
        if profiling is not None:
            self._stop_profiler(*profiling, pathlib.Path(self.config.profile))
        elapsed = time.time() - start
        logger.info(
            '[%s] split done: %d images in %.1fs (%.2f img/s)',
            self.name, done, elapsed, done / max(elapsed, 1e-6),
        )

    def _start_profiler(self, profile_dir) -> 'tuple[torch.profiler.profile, float] | None':
        """A started ``torch.profiler`` over the host and, on a card, the
        device, and its clock mark (``tracing.clock``); None without
        ``profile_dir``."""
        if not profile_dir:
            return None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler, tracing.clock()

    def _stop_profiler(self, profiler, mark: float, profile_dir: pathlib.Path) -> None:
        """Stop the profiler and write its trace into ``profile_dir`` under
        TensorBoard's name, with the spans of the runner's threads."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        profiler.stop()
        profile_dir.mkdir(parents=True, exist_ok=True)
        path = profile_dir / (
            f'{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json'
        )
        profiler.export_chrome_trace(str(path))
        tracing.merge(path, mark)
        logger.info('profiler trace written to %s', path)

    def run(self) -> None:
        config = self.config
        for split in ('val', 'train'):  # val first (reference base.py:136)
            if split in config:
                logger.info('[%s] running %s split', self.name, split)
                self.run_split(config[split])

    # -- CLI ---------------------------------------------------------------

    @classmethod
    def parse_args(cls, argv=None) -> argparse.Namespace:
        parser = argparse.ArgumentParser(description=cls.__doc__)
        parser.add_argument('name', type=str)
        parser.add_argument('config', type=Config.load)
        parser.add_argument('--override', action=DictAction, nargs='+')
        return parser.parse_args(argv)

    @classmethod
    def main(cls, argv=None) -> 'BaseOakePipeline':
        args = cls.parse_args(argv)
        config: Config = args.config
        if args.override:
            config.override(args.override)
        pipeline = cls(args.name, config)
        pipeline.run()
        return pipeline
