"""DP host-side data pipeline: COCO/LVIS datasets, OAKE feature loading,
augmentation, static-shape batch assembly. A copy of
``oadp_tpu/dp/datasets.py`` with its imports rewired; :func:`unpack_batch`
is written in torch. The evaluator (``dp/evaluator.py``) ships unpacked
batches: packing exists for a TPU transport that pays per transfer.

Replaces the reference's mmdet dataset + pipeline stack
(``oadp/dp/datasets.py``, ``configs/dp/datasets/ov_coco.py:20-65``):

* ``CocoDetDataset`` — annotation loading with the OV category order
  (labels = positions in ``categories.all_``; the OV annotation files
  already carry contiguous base-first ids, reference
  ``oadp/build_annotations.py:54-58``), mmdet-style empty-gt filtering,
  DRY_RUN truncation to 3 images (``oadp/dp/datasets.py:29-63``);
* ``LoadClipFeatures`` — per-sample reads from the three OAKE stores,
  block multi-labels by bbox-overlap against gts
  (``oadp/dp/datasets.py:185-201``), min-4x4 object re-filter;
* ``TrainTransform`` / ``TestTransform`` — multiscale range resize
  (keep-ratio), random horizontal flip applied to *all* box fields,
  mean/std normalization;
* ``BatchBuilder`` — TPU redesign of mmdet's pad-to-divisor batching:
  images land on one of two static canvases (landscape / portrait) and
  every variable-length field is padded + masked, so XLA compiles two
  programs total. The loader groups samples by orientation exactly like
  mmdet's aspect-ratio ``GroupSampler``.
"""

__all__ = [
    'CocoDetDataset',
    'ClassBalancedWrapper',
    'CorruptFeatureError',
    'LoadClipFeatures',
    'TrainTransform',
    'TestTransform',
    'BatchBuilder',
    'Loader',
]

import json
import pathlib
import queue as queue_mod
import threading
from typing import Any, Iterator

import numpy as np
import PIL.Image

import torch

from ..base import Categories
# ImageNet/caffe normalization constants (configs/dp/datasets/
# ov_coco.py:9-13) are defined ONCE in detector.py and shared with the
# on-device path (detector.ingest_images) so the host oracle and
# production normalization can never desynchronize.
from ..models.detector import IMG_MEAN, IMG_STD
from ..ops import boxes as B
from ..utils import PthAccessLayer, Store, logger


class CocoDetDataset:
    """Images + boxes + labels, OV category order."""

    def __init__(
        self,
        ann_file: str,
        img_prefix: str,
        categories: Categories,
        test_mode: bool = False,
        filter_empty_gt: bool = True,
        clip_features: 'LoadClipFeatures | None' = None,
        with_mask: bool = False,
    ) -> None:
        self.img_prefix = pathlib.Path(img_prefix)
        self.categories = categories
        self.test_mode = test_mode
        self.clip_features = clip_features
        self.with_mask = with_mask
        with open(ann_file) as f:
            data = json.load(f)
        self.dataset = data

        # label = index of the category in ann-file id order (for OV
        # files ids are already 0..K-1 in all_ order)
        cat_ids = sorted(c['id'] for c in data['categories'])
        self.cat_ids = cat_ids
        self.cat2label = {cid: i for i, cid in enumerate(cat_ids)}

        anns_by_img: dict[int, list] = {}
        for ann in data['annotations']:
            anns_by_img.setdefault(ann['image_id'], []).append(ann)
        self.images = list(data['images'])
        if not test_mode and filter_empty_gt:
            self.images = [
                img for img in self.images if anns_by_img.get(img['id'])
            ]
        if Store.DRY_RUN:
            self.images = self.images[:3]
        self.anns_by_img = anns_by_img

    def __len__(self) -> int:
        return len(self.images)

    def aspect_group(self, idx: int) -> int:
        """0 = landscape (w >= h), 1 = portrait — mmdet GroupSampler."""
        info = self.images[idx]
        return 0 if info['width'] >= info['height'] else 1

    def file_name(self, info: dict) -> str:
        # LVIS images carry only coco_url (reference
        # ``oadp/oake/objects.py:192-195``)
        if 'file_name' in info:
            return info['file_name']
        return info['coco_url'].replace(
            'http://images.cocodataset.org/', ''
        )

    def __getitem__(self, idx: int) -> dict[str, Any]:
        info = self.images[idx]
        path = self.img_prefix / self.file_name(info)
        with PIL.Image.open(path) as img:
            image = np.asarray(img.convert('RGB'))
        boxes, labels, polygons = [], [], []
        for ann in self.anns_by_img.get(info['id'], []):
            if ann.get('iscrowd', 0) and not self.test_mode:
                continue
            x, y, w, h = ann['bbox']
            if w < 1 or h < 1:
                continue
            boxes.append([x, y, x + w, y + h])
            labels.append(self.cat2label[ann['category_id']])
            if self.with_mask:
                seg = ann.get('segmentation') or []
                polygons.append(seg if isinstance(seg, list) else [])
        sample = {
            'image_id': info['id'],
            'image': image,
            'gt_boxes': np.asarray(boxes, np.float32).reshape(-1, 4),
            'gt_labels': np.asarray(labels, np.int64),
            'bbox_fields': ['gt_boxes'],
        }
        if self.with_mask:
            sample['gt_polygons'] = polygons
        if self.clip_features is not None:
            sample = self.clip_features(sample, self.categories)
        return sample


class CorruptFeatureError(RuntimeError):
    """An OAKE feature file exists but cannot be read (truncated write,
    disk fault). Training cannot regenerate features itself — the fix
    is an OAKE re-run with ``auto_fix=True`` (reference contract:
    ``oadp/oake/base.py:45-52``, README.md:211)."""


class LoadClipFeatures:
    """OAKE feature loading (reference ``LoadCLIPFeatures``,
    ``oadp/dp/datasets.py:137-214``).

    A corrupt/truncated ``.pth`` raises :class:`CorruptFeatureError`
    naming the store and key; the loader propagates it so the run fails
    loudly instead of silently truncating the epoch (the reference's
    dataloader workers likewise propagate the ``torch.load`` error)."""

    def __init__(
        self,
        globals_: str | None = None,
        blocks: str | None = None,
        objects: str | None = None,
    ) -> None:
        self._globals = PthAccessLayer(globals_) if globals_ else None
        self._blocks = PthAccessLayer(blocks) if blocks else None
        self._objects = PthAccessLayer(objects) if objects else None
        self._dry_key: str | None = None
        if Store.DRY_RUN:
            keys = [
                set(layer)
                for layer in (self._globals, self._blocks, self._objects)
                if layer is not None
            ]
            self._dry_key = sorted(set.intersection(*keys))[0]

    @staticmethod
    def _read(layer: PthAccessLayer, key: str, kind: str) -> Any:
        try:
            return layer[key]
        except FileNotFoundError:
            raise  # a MISSING file is a config/path problem, not corruption
        except Exception as e:
            raise CorruptFeatureError(
                f'corrupt OAKE {kind} feature file for key {key!r} '
                f'({e.__class__.__name__}: {e}); re-run the OAKE '
                f'{kind} pipeline with auto_fix=True to regenerate it'
            ) from e

    def __call__(
        self, sample: dict[str, Any], categories: Categories
    ) -> dict[str, Any]:
        key = self._dry_key or f'{sample["image_id"]:012d}'
        if self._globals is not None:
            g = np.asarray(
                self._read(self._globals, key, 'globals'), np.float32
            )
            sample['clip_global'] = g.reshape(-1)
        if self._blocks is not None:
            blocks = self._read(self._blocks, key, 'blocks')
            block_boxes = np.asarray(blocks['bboxes'], np.float32)
            sample['clip_blocks'] = np.asarray(
                blocks['embeddings'], np.float32
            )
            sample['block_boxes'] = block_boxes
            sample['bbox_fields'].append('block_boxes')
            gt_boxes = sample.get('gt_boxes')
            if gt_boxes is not None:
                num_all = categories.num_all
                labels = np.zeros(
                    (len(block_boxes), num_all), bool
                )
                gt_labels = sample['gt_labels']
                keep = gt_labels < num_all  # drop pseudo labels
                inter = B.pairwise_intersection(
                    block_boxes, gt_boxes[keep]
                )
                b_ids, g_ids = np.nonzero(inter > 0)
                labels[b_ids, gt_labels[keep][g_ids]] = True
                sample['block_labels'] = labels
        if self._objects is not None:
            objects = self._read(self._objects, key, 'objects')
            boxes = np.asarray(objects['bboxes'], np.float32)
            emb = np.asarray(objects['embeddings'], np.float32)
            keep = B.filter_min_wh(boxes, 4, 4)
            sample['clip_objects'] = emb[keep]
            sample['object_boxes'] = boxes[keep]
            sample['bbox_fields'].append('object_boxes')
        return sample


class TrainTransform:
    """Multiscale keep-ratio resize + random flip + normalize
    (``configs/dp/datasets/ov_coco.py:33-44``).

    Augmentation randomness derives from ``(seed, epoch, sample
    index)`` so it is deterministic and safe under the loader's
    thread-pooled fetching (a shared RandomState would race)."""

    def __init__(
        self,
        scales: tuple = ((1330, 640), (1333, 800)),
        flip_ratio: float = 0.5,
        seed: int = 0,
    ) -> None:
        self.scales = scales
        self.flip_ratio = flip_ratio
        self.seed = seed

    def __call__(
        self, sample: dict[str, Any], salt: tuple = (0, 0)
    ) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed,) + tuple(salt))
        (l0, s0), (l1, s1) = self.scales
        long = int(rng.integers(min(l0, l1), max(l0, l1) + 1))
        short = int(rng.integers(min(s0, s1), max(s0, s1) + 1))
        sample = resize_keep_ratio(sample, long, short)
        if rng.random() < self.flip_ratio:
            sample = flip_horizontal(sample)
        # images stay uint8: mean/std normalization runs ON DEVICE
        # (``models.detector.ingest_images``) — host-side fp32 math cost
        # ~35 ms/image on a 1-core host and tripled the transfer bytes
        return sample


class TestTransform:

    def __init__(self, scale: tuple = (1333, 800)) -> None:
        self.scale = scale

    def __call__(
        self, sample: dict[str, Any], salt: tuple = (0, 0)
    ) -> dict[str, Any]:
        # uint8 out; normalization is on-device (see TrainTransform)
        return resize_keep_ratio(sample, *self.scale)


def resize_keep_ratio(
    sample: dict[str, Any], long: int, short: int
) -> dict[str, Any]:
    image = sample['image']
    h, w = image.shape[:2]
    factor = min(long / max(h, w), short / min(h, w))
    new_w, new_h = int(w * factor + 0.5), int(h * factor + 0.5)
    pil = PIL.Image.fromarray(image)
    image = np.asarray(pil.resize((new_w, new_h), PIL.Image.BILINEAR))
    sample['image'] = image
    # mmdet records the actual w/h ratios
    wr, hr = new_w / w, new_h / h
    scale = np.asarray([wr, hr, wr, hr], np.float32)
    for field in sample['bbox_fields']:
        sample[field] = sample[field] * scale
    if 'gt_polygons' in sample:
        sample['gt_polygons'] = [
            [
                (np.asarray(p, np.float64).reshape(-1, 2)
                 * [wr, hr]).reshape(-1)
                for p in inst
            ]
            for inst in sample['gt_polygons']
        ]
    sample['scale_factor'] = scale
    sample['img_hw'] = np.asarray([new_h, new_w], np.float32)
    return sample


def flip_horizontal(sample: dict[str, Any]) -> dict[str, Any]:
    image = sample['image']
    w = image.shape[1]
    sample['image'] = image[:, ::-1]
    for field in sample['bbox_fields']:
        boxes = sample[field].copy()
        boxes[..., 0] = w - sample[field][..., 2]
        boxes[..., 2] = w - sample[field][..., 0]
        sample[field] = boxes
    if 'gt_polygons' in sample:
        def flip_part(p):
            pts = np.asarray(p, np.float64).reshape(-1, 2)
            pts[:, 0] = w - pts[:, 0]
            return pts.reshape(-1)

        sample['gt_polygons'] = [
            [flip_part(p) for p in inst]
            for inst in sample['gt_polygons']
        ]
    return sample


def normalize(sample: dict[str, Any]) -> dict[str, Any]:
    """Host-side mean/std normalization (mmdet ``Normalize``). The
    production loaders no longer call this — normalization is fused
    into the jitted forward (``models.detector.ingest_images``) — but
    the semantics are kept here for oracle tests."""
    sample['image'] = (
        sample['image'].astype(np.float32) - IMG_MEAN
    ) / IMG_STD
    return sample


# keys that stay on the host (consumed by the python loop, never by the
# jitted step)
_PACK_SKIP = ('image_ids', 'scale_factor')


def pack_batch(batch: dict[str, Any]) -> dict[str, Any]:
    """Pack every device-bound field into ONE ``(b, S)`` uint8 buffer.

    On tunneled/remote TPU transports each transfer operation is a
    serialized round trip regardless of size, so a ~13-array batch dict
    costs ~13 round-trip initiations per step on the host thread. The
    packed layout ships the whole batch as a single ``device_put`` whose
    bytes ride one transfer; the jitted step unpacks with reshape +
    ``bitcast_convert_type`` (free on device). Rows are per-sample, so
    a data-parallel ``PartitionSpec('data')`` on dim 0 still shards by
    sample. Packing runs on the loader worker thread (``Loader.epoch``
    calls the builder there), keeping the host hot loop at one transfer
    initiation + one dispatch per step.

    Returns a dict with ``packed`` ``(b, S) uint8``, a hashable
    ``_pack_spec`` describing the layout (static per canvas), and the
    host-side keys (``image_ids``, ``scale_factor``) untouched.
    """
    b = batch['images'].shape[0]
    spec: list[tuple] = []
    parts: list[np.ndarray] = []
    off = 0
    for k in sorted(batch):
        if k in _PACK_SKIP:
            continue
        v = batch[k]
        store = v.astype(np.uint8) if v.dtype == np.bool_ else v
        rows = np.ascontiguousarray(
            store.reshape(b, -1)
        ).view(np.uint8)
        pad = (-rows.shape[1]) % 4  # 4-byte lanes for the bitcast
        if pad:
            rows = np.concatenate(
                [rows, np.zeros((b, pad), np.uint8)], axis=1
            )
        spec.append((k, v.shape, str(v.dtype), off,
                     store.size // b * store.dtype.itemsize))
        off += rows.shape[1]
        parts.append(rows)
    out = {k: batch[k] for k in _PACK_SKIP if k in batch}
    out['packed'] = np.concatenate(parts, axis=1)
    out['_pack_spec'] = tuple(spec)
    return out


def unpack_batch(buf: torch.Tensor, spec) -> dict[str, Any]:
    """Invert :func:`pack_batch` on a ``(b, S)`` uint8 tensor (on any
    device): each field's byte columns viewed as its dtype. ``spec`` is
    the layout from ``_pack_spec``."""
    # batch dim comes from the BUFFER, not the spec: callers may pad a
    # tail batch by repeating packed rows
    b = buf.shape[0]
    out = {}
    for k, shape, dtype, off, nbytes in spec:
        shape = (b,) + tuple(shape[1:])
        seg = buf[:, off:off + nbytes].contiguous()
        if dtype == 'bool':
            out[k] = seg.reshape(shape) != 0
        elif dtype == 'uint8':
            out[k] = seg.reshape(shape)
        else:
            tdtype = getattr(torch, np.dtype(dtype).name)
            out[k] = seg.view(tdtype).reshape(shape)
    return out


def batch_canvas(batch: dict[str, Any]) -> tuple[int, int]:
    """The ``(H, W)`` canvas of a batch, packed or plain."""
    if 'packed' in batch:
        for k, shape, *_ in batch['_pack_spec']:
            if k == 'images':
                return tuple(shape[1:3])
        raise KeyError('packed batch without images field')
    return tuple(batch['images'].shape[1:3])


class BatchBuilder:
    """Pad a list of samples to one static-canvas batch (numpy)."""

    def __init__(
        self,
        canvas: tuple[int, int] = (832, 1344),  # (H, W), landscape
        max_gts: int = 100,
        max_blocks: int = 128,
        max_objects: int = 512,
        embedding_dim: int = 512,
        num_all: int = 65,
        with_clip: bool = True,
        with_mask: bool = False,
        max_polygon_parts: int = 8,
        max_polygon_verts: int = 96,
        pack: bool = False,
    ) -> None:
        self.pack = pack
        self.canvas = canvas
        self.max_gts = max_gts
        self.max_blocks = max_blocks
        self.max_objects = max_objects
        self.embedding_dim = embedding_dim
        self.num_all = num_all
        self.with_clip = with_clip
        self.with_mask = with_mask
        self.max_polygon_parts = max_polygon_parts
        self.max_polygon_verts = max_polygon_verts

    def _canvas_for(self, samples) -> tuple[int, int]:
        h, w = self.canvas
        if samples[0]['image'].shape[0] > samples[0]['image'].shape[1]:
            h, w = w, h  # portrait group
        return h, w

    def __call__(self, samples: list[dict[str, Any]]) -> dict[str, Any]:
        b = len(samples)
        ch, cw = self._canvas_for(samples)
        d = self.embedding_dim

        def pad_rows(key, n, trailing):
            out = np.zeros((b, n) + trailing, np.float32)
            valid = np.zeros((b, n), bool)
            for i, s in enumerate(samples):
                v = s.get(key)
                if v is None:
                    continue
                m = min(len(v), n)
                out[i, :m] = v[:m]
                valid[i, :m] = True
            return out, valid

        # canvas dtype follows the sample images: uint8 from the
        # production transforms (normalized on device), float when a
        # caller pre-normalized on host
        images = np.zeros(
            (b, ch, cw, 3), samples[0]['image'].dtype
        )
        img_hw = np.zeros((b, 2), np.float32)
        for i, s in enumerate(samples):
            img = s['image']
            h, w = img.shape[:2]
            assert h <= ch and w <= cw, (img.shape, (ch, cw))
            images[i, :h, :w] = img
            img_hw[i] = s['img_hw']

        gt_boxes, gt_valid = pad_rows('gt_boxes', self.max_gts, (4,))
        gt_labels = np.zeros((b, self.max_gts), np.int32)
        for i, s in enumerate(samples):
            m = min(len(s['gt_labels']), self.max_gts)
            gt_labels[i, :m] = s['gt_labels'][:m]

        gt_polygons = None
        if self.with_mask:
            from ..ops.masks import resample_polygons
            gt_polygons = np.full(
                (b, self.max_gts, self.max_polygon_parts,
                 self.max_polygon_verts, 2),
                -1e6, np.float32,
            )
            for i, s in enumerate(samples):
                for gi, inst in enumerate(
                    s.get('gt_polygons', [])[:self.max_gts]
                ):
                    gt_polygons[i, gi] = resample_polygons(
                        inst, self.max_polygon_parts,
                        self.max_polygon_verts,
                    )

        batch = {
            'images': images,
            'img_hw': img_hw,
            'gt_boxes': gt_boxes,
            'gt_labels': gt_labels,
            'gt_valid': gt_valid,
            'image_ids': np.asarray([s['image_id'] for s in samples]),
            'scale_factor': np.stack(
                [s['scale_factor'] for s in samples]
            ),
        }
        if gt_polygons is not None:
            batch['gt_polygons'] = gt_polygons
        if self.with_clip:
            batch['clip_global'] = np.stack([
                s.get('clip_global', np.zeros(d, np.float32))
                for s in samples
            ])
            batch['block_boxes'], batch['block_valid'] = pad_rows(
                'block_boxes', self.max_blocks, (4,)
            )
            batch['clip_blocks'], _ = pad_rows(
                'clip_blocks', self.max_blocks, (d,)
            )
            labels = np.zeros(
                (b, self.max_blocks, self.num_all), np.float32
            )
            for i, s in enumerate(samples):
                v = s.get('block_labels')
                if v is not None:
                    m = min(len(v), self.max_blocks)
                    labels[i, :m] = v[:m]
            batch['block_labels'] = labels
            batch['object_boxes'], batch['object_valid'] = pad_rows(
                'object_boxes', self.max_objects, (4,)
            )
            batch['clip_objects'], _ = pad_rows(
                'clip_objects', self.max_objects, (d,)
            )
        if self.pack:  # single-transfer batches (see pack_batch)
            return pack_batch(batch)
        return batch


class ClassBalancedWrapper:
    """mmdet ``ClassBalancedDataset`` (LVIS oversampling, reference
    ``configs/dp/datasets/ov_lvis.py:19-21``): image repeat factor =
    ``max_c max(1, sqrt(thr / freq(c)))`` over its categories."""

    def __init__(self, dataset: CocoDetDataset, oversample_thr: float):
        self.dataset = dataset
        n = len(dataset)
        freq: dict[int, float] = {}
        img_cats = []
        for info in dataset.images:
            cats = {
                dataset.cat2label[a['category_id']]
                for a in dataset.anns_by_img.get(info['id'], [])
            }
            img_cats.append(cats)
            for c in cats:
                freq[c] = freq.get(c, 0) + 1
        freq = {c: v / n for c, v in freq.items()}
        cat_repeat = {
            c: max(1.0, (oversample_thr / f) ** 0.5)
            for c, f in freq.items()
        }
        self._indices: list[int] = []
        rng = np.random.RandomState(0)
        for i, cats in enumerate(img_cats):
            r = max([cat_repeat[c] for c in cats], default=1.0)
            n_rep = int(np.floor(r))
            if rng.rand() < (r - n_rep):
                n_rep += 1
            self._indices.extend([i] * max(n_rep, 1))

    def __len__(self) -> int:
        return len(self._indices)

    def aspect_group(self, idx: int) -> int:
        return self.dataset.aspect_group(self._indices[idx])

    def __getitem__(self, idx: int):
        return self.dataset[self._indices[idx]]


class Loader:
    """Orientation-grouped, process-sharded, prefetching batch loader."""

    def __init__(
        self,
        dataset: CocoDetDataset,
        builder: BatchBuilder,
        batch_size: int,
        transform,
        shuffle: bool,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        workers: int = 4,
    ) -> None:
        self.dataset = dataset
        self.builder = builder
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.workers = workers

    def _index_batches(self, epoch: int) -> list[list[int]]:
        rng = np.random.RandomState(self.seed + epoch)
        groups: dict[int, list[int]] = {0: [], 1: []}
        for i in range(len(self.dataset)):
            groups[self.dataset.aspect_group(i)].append(i)
        group_batches: list[list[list[int]]] = []
        for idx in groups.values():
            idx = np.asarray(idx)
            if self.shuffle:
                rng.shuffle(idx)
            # round up to full batches by wrapping (train only)
            n = len(idx)
            if n == 0:
                continue
            bs = self.batch_size
            if self.shuffle and n % bs:
                # wrap to a full batch; tile when the global batch
                # exceeds the (sharded) dataset
                pad = bs - n % bs
                reps = np.tile(idx, -(-pad // n))[:pad]
                idx = np.concatenate([idx, reps])
            gb = [
                list(idx[j:j + bs])
                for j in range(0, len(idx) - bs + 1, bs)
            ]
            if not self.shuffle and len(idx) % bs:
                gb.append(list(idx[-(len(idx) % bs):]))
            group_batches.append(gb)
        pc = self.process_count
        if pc > 1:
            # Lockstep alignment: the step-k batch on EVERY process
            # must come from the same aspect group — the jitted
            # train/eval program is canvas-keyed, and a multi-process
            # mesh requires all processes to launch the SAME compiled
            # collective program in the same order. So (a) pad each
            # group's batch count to a multiple of pc by repeating
            # whole batches from the group's front (every process also
            # ends up with the same batch count — one extra batch on
            # one rank would hang the others' collectives; eval dedups
            # the repeats by image id at the rank-0 merge, train wraps
            # anyway), then (b) emit rounds of pc same-group batches.
            rounds: list[list[list[int]]] = []
            for gb in group_batches:
                if len(gb) % pc:
                    pad = pc - len(gb) % pc
                    gb = gb + [gb[i % len(gb)] for i in range(pad)]
                rounds += [gb[j:j + pc] for j in range(0, len(gb), pc)]
            if self.shuffle:
                order = rng.permutation(len(rounds))
                rounds = [rounds[i] for i in order]
            batches = [b for r in rounds for b in r]
        else:
            batches = [b for gb in group_batches for b in gb]
            if self.shuffle:
                order = rng.permutation(len(batches))
                batches = [batches[i] for i in order]
        return batches[self.process_index::pc]

    def epoch(self, epoch: int = 0, start: int = 0) -> Iterator[dict[str, Any]]:
        """Yield batches with background prefetch.

        ``start`` skips the first ``start`` batches WITHOUT building
        them — the deterministic-resume path re-enters an epoch at the
        checkpointed position (the batch order is a pure function of
        ``(seed, epoch)``, so the remaining order is identical to the
        uninterrupted run's).
        """
        batches = self._index_batches(epoch)[start:]
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)

        def worker():
            # JPEG decode / PIL resize / numpy release the GIL, so
            # per-sample fetches parallelize across threads (the
            # reference uses dataloader worker processes instead)
            from concurrent.futures import ThreadPoolExecutor
            try:
                with ThreadPoolExecutor(max(self.workers, 1)) as pool:
                    def fetch(i):
                        return self.transform(
                            self.dataset[i], salt=(epoch, i)
                        )

                    for idxs in batches:
                        samples = list(pool.map(fetch, idxs))
                        q.put(self.builder(samples))
            except Exception as e:
                # propagate to the consumer — swallowing the error here
                # would silently END THE EPOCH EARLY (e.g. a corrupt
                # OAKE feature file would quietly shrink training).
                # torch's DataLoader workers likewise re-raise in the
                # main process.
                logger.exception('loader worker failed')
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def __len__(self) -> int:
        return len(self._index_batches(0))
