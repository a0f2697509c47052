"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

1. card: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: the CUDA kernels of ``oadp_torch/csrc`` (nvcc, sm_90a), timed,
   and ``long_attention_kernel``'s ptxas report from the build's log (no
   serialised wgmma, no spill: :func:`long_attention_build`);
3. kernels: every ``cuda``-marked test of ``tests/test_torch_*.py``, each
   kernel's one check on the card against its plain version at the main
   path's shapes and at its edge shapes (``python3 -m pytest -m cuda`` in a
   child process, its exit code the gate, the count it ran logged). The
   kernels' times are ``python3 -m oadp_torch.profile_kernels``'s;
4. main path, each part with the launch counts set to 0 just before it
   and checked just after (12 launches of each of its kernels a
   dispatch, but 11 of kernel 4 on the split wiring and 11 of
   ``ln_mlp_residual`` on the fused one, whose last layers compute the
   side row alone; one of ``resize_crops`` an objects or globals
   dispatch, and one each of ``patch_rows``, the patch product and
   ``embed_ln_pre`` an encoder dispatch; every other kernel 0; the table
   in ``main_path``):
   the OAKE objects, globals and blocks
   CLIs (``oadp_torch.oake``) at full ViT-B/32 width (random weights from
   seed 0, bf16) on 4 synthetic images with 1000 proposals each, every
   record checked; the surgery encoder's split wiring (``objects_step``
   on 999 crops: kernels 4 and 5 only) against its fused wiring on the
   first 1000 of the same crops (kernels 1 and 2; cosine >= 0.99), both
   timed; CPU fp32 re-encodes of crops (fused and split), a whole image
   (globals) and blocks against the card (cosine >= 0.99); images/s of a
   warm second run of each CLI;
5. ViLD prompts: a random fp16 CLIP checkpoint in the OpenAI layout (both
   towers at ViT-B/32 width, seed 0) and a synthetic merges file of a
   CLIP vocabulary's size, then the prompt CLI (``oadp_torch.prompts.vild``)
   on the card: every COCO/LVIS name (1217) through every template, fp32,
   with the launch counts at 0 before it and checked at 0 after (the text
   encoder takes no fused kernel); the record checked (names, (1217, 512)
   finite embeddings, row norms in (0, 1]) and its rows per second and ms
   per 256-row batch printed; the prompt builder on 16 names and 3
   templates on the card against the same on the CPU (cosine >= 0.99999,
   max abs <= 2e-4); the native COCO matcher built with g++ and held to
   its Python version on random cases;
6. DP inference, with the launch counts at 0 before it and checked after
   (no attention kernel; ``greedy_nms`` once for each RPN call and each
   ``multiclass_nms``, two a loader batch of one image; no plain greedy
   pass loop on the card): a random mmdet-layout
   detector checkpoint (ResNet-50 + FPN + RPN + the bbox, object and mask
   heads, seed 0) and 8 synthetic COCO-size images (landscape and
   portrait: both canvases) with the 65 OV-COCO categories, then
   ``python -m oadp_torch.dp.test`` with ``configs/dp/oadp_ov_coco.py`` at
   full width, phase 5's ``vild.pth`` as the prompts, fp32 (TF32 off),
   twice (images/s of the warm run, its evaluator loop and its COCO
   evaluation apart), then with bf16 activations, then once more fp32
   with ``DUMP=<dir>`` (one logit record an image, each checked: phase
   8's input); every image's detections checked (finite, inside the
   image, known labels, at most 300, scores descending) and the OV-COCO
   metric keys; OV-LVIS Mask
   R-CNN (``configs/dp/oadp_ov_lvis.py``, C = 1203) on 2 images with the
   LVIS bbox and segm evaluation, masks (300, 28, 28) in [0, 1];
   ``simple_test`` on one image by stage (CUDA events; backbone + FPN, RPN
   head, proposals + NMS, RoIAlign, the two heads, ``multiclass_nms``,
   the rest; the NMS kernel's calls apart, and its launches) with the
   device's idle share from ``torch.profiler``, for OV-COCO and
   OV-LVIS; the card against the CPU on one image, fp32: RPN logits, the
   pre-NMS probs on the card's proposals (max rel <= 1e-3 above 1e-4),
   ``multiclass_nms`` and ``batched_nms`` on the card over the CPU's exact
   inputs (identical keep sets), the final detections (>= 95% of the
   CPU's top 100 with a card detection of the same label, IoU >= 0.99,
   |score difference| <= 1e-3); bf16 activations against fp32 on the same
   proposals (pre-NMS probs cosine >= 0.999);
7. DP training, with the launch counts at 0 before and checked after (no
   attention kernel, ``greedy_nms`` once a step of two images and twice
   an image of ``dp.test``, no plain greedy pass loop on the card): a COCO
   train annotation file for phase 4's images (3-8 boxes each over the 48
   base classes), then ``python -m oadp_torch.dp.train`` with
   ``configs/dp/oadp_ov_coco.py`` at full width on those images and the
   OAKE records phase 4 wrote for them, phase 6's checkpoint as
   ``load_from`` and phase 5's prompts: 20 iterations at batch 2 in bf16
   (checkpoints at 10 and 20), a resume from iteration 10 to 20 (the same
   step and lr; a ``torch.profiler`` window of 4 steps for the device's
   idle share), and ``python -m oadp_torch.dp.test`` on the trained
   checkpoint (phase 6's checks on every image). Gates: every logged loss
   finite; frozen leaves bit-unchanged, every trainable leaf moved; the
   backbone's running statistics unchanged (``norm_eval``), the FPN's and
   heads' moved. Printed on the ``dp_train`` line: ms per step (CUDA
   events, median of iterations 5-20), images/s, ms by stage (backbone,
   FPN, RPN head, RPN loss with assign and sample, proposals + NMS (the
   kernel's calls apart, and its launches), RCNN sampling, RoIAlign, the three heads, the global
   head, backward, SGD update), peak memory, RoIAlign's forward and
   backward at the step's 2 x 1152 RoIs. Then one fp32 step (TF32 off)
   on the card against the CPU from the same params, image and draws, the
   card on the CPU's proposals: identical samples, losses within max rel
   1e-3 (above 1e-5), every trainable leaf's update with cosine >= 0.999;
   the card on its own proposals and in bf16 are printed beside it. Then
   one bf16 step with ``--override .model.backbone.norm_eval:False``:
   finite losses, and the running statistics of every backbone stage
   moved (the frozen stem and stage 1 too, as ``oadp_tpu`` trains them).
   Last, one OV-LVIS Mask R-CNN train step (``configs/dp/oadp_ov_lvis.py``,
   C = 1203, masks) on the card in bf16 on a synthetic batch at the LVIS
   train batch's sizes: finite losses, every mask-head leaf moved;
8. calibration, with the launch counts at 0 before the CLIs and checked
   after them (no attention kernel, ``greedy_nms`` once a 32-image
   ``rescore`` batch of a trial, no plain greedy pass loop on the card):
   ``python -m
   oadp_torch.dp.test_calibrate`` on the card over phase 6's 8 DUMP
   records (C = 65 + background, 1000 proposals an image, 300
   detections; its JSON line checked), ``python -m
   oadp_torch.dp.calibrate_sweep`` for 5 TPE trials, and the card's
   ``CalibrationRunner`` against the CPU's on the same records at the
   defaults and two perturbed settings: identical labels, rows and valid
   flags, scores within max rel 1e-5, equal OV-COCO metrics dicts. One
   32-image ``rescore`` batch (the 8 records 4 times) timed with CUDA
   events, its device time and idle share from ``torch.profiler``, its
   NMS launch (one) counted and timed; the COCO evaluation's seconds for the 8 images;
   an estimate (so labelled) of one trial over the 4,952 OV-COCO val
   images. All of it on the ``calibration`` line.

The last line is the result line ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

import gzip
import json
import math
import os
import pathlib
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SPLIT_BATCH = 999  # crops of the split-wiring objects_step (B % 8 != 0)
N_IMAGES, N_PROPOSALS = 4, 1000
SIZES = [(640, 480), (480, 640), (640, 427), (500, 375)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return out


def ptxas_report(log_text: str, source: str, kernel: str) -> dict:
    """What ``nvcc -Xptxas -v`` said of ``kernel`` in ``source``'s section
    of the library's ``build.log`` (a ``== <source>`` line heads each
    source's output): its registers, spill bytes, stack and static shared
    memory, the section's ptxas notes that say wgmma was serialised, and
    its warnings that name the kernel."""
    sections, name = {}, None
    for line in log_text.splitlines():
        if line.startswith('== '):
            name = line[3:].strip()
            sections[name] = []
        elif name is not None:
            sections[name].append(line)
    if source not in sections:
        raise AssertionError(f'build.log has no section for {source}')
    report = dict(kernel=kernel, registers=None, spill_stores=None, spill_loads=None,
                  stack_bytes=None, static_smem_bytes=0, serialized=[], warnings=[])
    current = None
    for line in sections[source]:
        entry = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if entry:
            current = entry.group(1)
            continue
        if 'serialized' in line:  # ptxas says so in an info line (C7510-C7520)
            report['serialized'].append(line.strip())
        elif 'warning' in line and kernel in line:
            report['warnings'].append(line.strip())
        if current is None or kernel not in current:
            continue
        for key, pattern in (('stack_bytes', r'(\d+) bytes stack frame'),
                             ('spill_stores', r'(\d+) bytes spill stores'),
                             ('spill_loads', r'(\d+) bytes spill loads'),
                             ('registers', r'Used (\d+) registers'),
                             ('static_smem_bytes', r'(\d+) bytes smem')):
            found = re.search(pattern, line)
            if found:
                report[key] = int(found.group(1))
    if report['registers'] is None:
        raise AssertionError(f'build.log: no ptxas report of {kernel} in {source}')
    return report


def long_attention_build() -> dict:
    """``long_attention_kernel``'s ptxas report from the library's
    ``build.log``; raises if ptxas serialised a wgmma of
    ``long_attention.cu`` or the kernel spills."""
    from oadp_torch.ops import cuda_lib

    report = ptxas_report((cuda_lib.build_dir() / 'build.log').read_text(),
                          'long_attention.cu', 'long_attention_kernel')
    if report['serialized'] or report['spill_stores'] or report['spill_loads']:
        raise AssertionError(f'long_attention_kernel: ptxas {report}')
    return report


def reset_launches() -> None:
    """Every kernel's launch count to 0: ``ops/attention.py``'s five and its
    ``ln_gemm`` routes, ``ops/nms.py``'s ``greedy_nms``, ``ops/preprocess.py``'s
    ``resize_crops`` and ``ops/embed.py``'s three."""
    from oadp_torch.ops import attention, embed, nms, preprocess

    for mod in (attention, nms, preprocess, embed):
        mod.reset_launches()


def launch_counts() -> dict:
    from oadp_torch.ops import attention, embed, nms, preprocess

    return {**attention.LAUNCHES, **nms.LAUNCHES, **preprocess.LAUNCHES, **embed.LAUNCHES}


def cuda_tests() -> dict:
    """Phase 3: every ``cuda``-marked test of ``tests/test_torch_*.py`` in a
    child ``pytest``; raises unless it exits 0."""
    repo = pathlib.Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'pytest', '-m', 'cuda', '-q', '-p', 'no:cacheprovider',
         *sorted(str(f.relative_to(repo)) for f in (repo / 'tests').glob('test_torch_*.py'))],
        cwd=repo, capture_output=True, text=True, timeout=3000)
    summary = proc.stdout.strip().splitlines()[-1:]
    counts = {word: int(n) for line in summary
              for n, word in re.findall(r'(\d+) (passed|failed|skipped|deselected|errors?)', line)}
    res = dict(returncode=proc.returncode, counts=counts, seconds=time.perf_counter() - t0)
    log(json.dumps({'cuda_tests': res}))
    if proc.returncode != 0:
        log(proc.stdout[-20000:] + proc.stderr[-4000:])
        raise AssertionError(f'pytest -m cuda exited {proc.returncode}: {counts}')
    return res


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def make_data(root: pathlib.Path, seed: int = 0) -> dict:
    """A few JPEGs, a COCO annotation file and a proposal pickle."""
    import PIL.Image

    rng = np.random.RandomState(seed)
    img_dir = root / 'images'
    img_dir.mkdir(parents=True)
    images, proposals = [], []
    for i, (w, h) in enumerate(SIZES[:N_IMAGES]):
        id_ = i + 1
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1)
        arr = np.clip(base + rng.randint(-40, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        name = f'{id_:012d}.jpg'
        PIL.Image.fromarray(arr).save(img_dir / name, quality=90)
        images.append(dict(id=id_, file_name=name, width=w, height=h))
        x0 = rng.uniform(0, w * 0.8, N_PROPOSALS)
        y0 = rng.uniform(0, h * 0.8, N_PROPOSALS)
        bw = rng.uniform(8, w * 0.5, N_PROPOSALS)
        bh = rng.uniform(8, h * 0.5, N_PROPOSALS)
        proposals.append(np.stack([
            x0, y0, np.minimum(x0 + bw, w), np.minimum(y0 + bh, h),
            rng.uniform(0, 1, N_PROPOSALS),
        ], -1).astype(np.float32))
    ann = root / 'instances.json'
    ann.write_text(json.dumps(dict(images=images, annotations=[], categories=[])))
    prop = root / 'proposals.pkl'
    with open(prop, 'wb') as f:
        pickle.dump(proposals, f)
    return dict(root=str(img_dir), ann=str(ann), proposals=prop,
                raw=proposals, ids=[im['id'] for im in images])


def write_config(base: str, root: pathlib.Path, data: dict, out: str) -> pathlib.Path:
    """The repo's OAKE config with its val split pointed at the synthetic
    data and no train split."""
    from oadp_torch.utils import Config

    cfg = Config.load(base)
    cfg.pop('train', None)
    ds = cfg.val.dataloader.dataset
    ds.root, ds.annFile, ds.output_dir = data['root'], data['ann'], out
    if 'proposal_file' in ds:
        ds.proposal_file = str(data['proposals'])
    path = root / f'{pathlib.Path(base).stem}.py'
    cfg.dump(path)
    return path


def _wall_ms(fn, reps: int = 3) -> float:
    """Milliseconds per call on the host clock, synchronised, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _min_cos(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                       * np.linalg.norm(b, axis=-1))).min())


def _unit_rows(name, emb, rows: int) -> None:
    if emb.shape != (rows, 512) or emb.dtype != np.float16 or not np.isfinite(emb).all():
        raise AssertionError(f'{name}: {emb.shape} {emb.dtype}')
    if np.abs(np.linalg.norm(emb.astype(np.float32), axis=-1) - 1).max() > 1e-2:
        raise AssertionError(f'{name}: not unit rows')


def main_path(card: str, root: pathlib.Path) -> dict:
    """The OAKE CLIs (objects, globals, blocks) and the split-wiring
    objects step, each driven with every launch count set to 0 just before
    it and read just after."""
    from oadp_torch.oake import blocks as BL
    from oadp_torch.oake import encoders as E
    from oadp_torch.oake import globals as G
    from oadp_torch.oake import objects as O
    from oadp_torch.oake.base import bucket
    from oadp_torch.oake.partitions import first_block_bbox, plan_blocks
    from oadp_torch.utils import load_pth

    repo = pathlib.Path(__file__).resolve().parent
    steps_of = dict(objects='objects_packed_step', globals='globals_step',
                    blocks='blocks_step')
    calls = {name: 0 for name in steps_of}
    originals = {name: getattr(E.OakeSteps, attr) for name, attr in steps_of.items()}

    def counted(name):
        def step(self, *a, **k):
            calls[name] += 1
            return originals[name](self, *a, **k)
        return step

    for name, attr in steps_of.items():
        setattr(E.OakeSteps, attr, counted(name))

    def driven(label, fn, expect):
        """``fn()`` with the launch counts from 0; checks them against
        ``expect`` (every kernel not named there: 0 launches)."""
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = launch_counts()
        want = {k: expect().get(k, 0) for k in launches}
        log(json.dumps({'launches': {label: launches}, 'dispatches': dict(calls)}))
        if launches != want or not all(expect().values()):
            raise AssertionError(f'{label}: launch counts {launches} != expected {want}')
        return out, launches

    data = make_data(root)
    cfgs = {name: write_config(str(repo / f'configs/oake/{base}.py'), root, data,
                               str(root / name))
            for name, base in (('objects', 'objects_coco'), ('globals', 'globals'),
                               ('blocks', 'blocks'))}
    override = ['--override', ".model.device:'cuda'", ".model.dtype:'bfloat16'"]

    def embed(n, crops=True):  # the patch embedding's launches, and resize_crops'
        return dict({k: n for k in ('patch_rows', 'patch_embed', 'embed_ln_pre')},
                    **({'resize_crops': n} if crops else {}))

    def stock(name):  # a stock-encoder dispatch: kernel 3 and both ln_gemm routes
        return dict({k: 12 * calls[name] for k in (
            'fused_ln_qkv_attention', 'ln_mlp_residual', 'out_proj_residual')},
            **embed(calls[name], crops=name == 'globals'))

    objects, l_obj = driven('objects', lambda: O.main(
        ['smoke_objects', str(cfgs['objects']), *override]), lambda: {
            'fused_surgery_layer': 12 * calls['objects'],
            'fused_ln_mlp_rows': 12 * calls['objects'],
            'ln_mlp_residual': 11 * calls['objects'], **embed(calls['objects'])})
    globals_, l_glob = driven('globals', lambda: G.main(
        ['smoke_globals', str(cfgs['globals']), *override]), lambda: stock('globals'))
    blocks, l_blocks = driven('blocks', lambda: BL.main(
        ['smoke_blocks', str(cfgs['blocks']), *override]), lambda: stock('blocks'))
    dispatches = dict(calls)
    cfg = objects.model.config
    if (cfg.width, cfg.layers, cfg.heads, objects.model.surgery_config.tokens) != (
            768, 12, 12, 197):
        raise AssertionError(f'not the full ViT-B/32: {cfg}')

    for i, id_ in enumerate(data['ids']):
        rec = load_pth(root / 'objects' / f'{id_:012d}.pth')
        raw = data['raw'][i]
        _unit_rows(f'objects {id_}', rec['embeddings'], len(raw))
        np.testing.assert_array_equal(rec['bboxes'], raw[:, :4].astype(np.float16))
        np.testing.assert_array_equal(rec['objectness'], raw[:, 4:].astype(np.float16))
        g = load_pth(root / 'globals' / f'{id_:012d}.pth')
        _unit_rows(f'globals {id_}', g[None], 1)
        w, h = SIZES[i]
        plan = plan_blocks(w, h, blocks.block_size, blocks.max_stride, blocks.rescale)
        rec = load_pth(root / 'blocks' / f'{id_:012d}.pth')
        _unit_rows(f'blocks {id_}', rec['embeddings'], 1 + len(plan.blocks))
        np.testing.assert_array_equal(rec['bboxes'], np.asarray(
            [first_block_bbox(w, h)] + plan.bboxes, np.float32).astype(np.float16))

    # the first image's first chunk of crops, as the objects CLI packs it
    item = dict(id=data['ids'][0], output=None, proposals=dict(
        (id_, p) for id_, p in zip(data['ids'], data['raw'])))
    item['image'] = objects._dataset.load(item['id'])
    item['height'], item['width'] = item['image'].shape[:2]
    prep = objects.prepare(item)
    buf, rows, m = prep['chunks'][0]
    n_img, grid = objects.pad * objects.pad * 3, objects.model.grid
    image = buf[:n_img].reshape(objects.pad, objects.pad, 3)
    masks = buf[n_img:n_img + rows * grid * grid].reshape(rows, grid, grid)[:m]
    meta = buf[n_img + rows * grid * grid:].view(np.float32).reshape(rows, 9)[:m]
    k_pad = prep['k']

    # split path: objects_step on 999 crops (B % 8 != 0) against the
    # fused wiring on the first 1000 of the same crops
    card_steps = objects.steps
    nb = SPLIT_BATCH
    split, l_split = driven('split', lambda: card_steps.objects_step(
        image, meta[:nb], masks[:nb], k_pad).float().cpu().numpy(), lambda: {
            'fused_mha_qkv': 11, 'fused_side_attention': 12, **embed(1)})
    fused, _ = driven('fused', lambda: card_steps.objects_step(
        image, meta[:nb + 1], masks[:nb + 1], k_pad).float().cpu().numpy(), lambda: {
            'fused_surgery_layer': 12, 'fused_ln_mlp_rows': 12, 'ln_mlp_residual': 11,
            **embed(1)})
    split_vs_fused = _min_cos(split, fused[:nb])
    split_ms = _wall_ms(lambda: card_steps.objects_step(image, meta[:nb], masks[:nb], k_pad))
    fused_ms = _wall_ms(
        lambda: card_steps.objects_step(image, meta[:nb + 1], masks[:nb + 1], k_pad))

    # CPU fp32 re-encodes: 8 crops (fused wiring on the CPU too) against
    # the objects record, 7 crops (split) against the split step, and a
    # whole image and 4 blocks against the blocks record
    cpu_model = E.load_clip(objects.config.model.checkpoint, 'float32', device='cpu')
    cpu_steps = E.OakeSteps(cpu_model, objects.pad, objects.pad)
    emb_cpu = cpu_steps.objects_step(image, meta[:8], masks[:8], k_pad).float().numpy()
    emb_card = load_pth(root / 'objects' / f'{item["id"]:012d}.pth')['embeddings'][:8]
    cos = {'objects_fused_8': _min_cos(emb_cpu, emb_card)}
    emb_cpu = cpu_steps.objects_step(image, meta[:7], masks[:7], k_pad).float().numpy()
    cos['objects_split_7'] = _min_cos(emb_cpu, split[:7])
    bprep = blocks.prepare(dict(item, output=None))
    n_check = 4
    coords = np.concatenate([np.zeros((n_check, 1), np.int32),
                             bprep['coords'][:n_check]], 1)
    emb_cpu = cpu_steps.blocks_step(
        bprep['image'][None], *([bprep[k].cpu()] for k in (
            'level_wx', 'level_wy', 'whole_wx', 'whole_wy')), coords,
    ).float().numpy()
    emb_card = load_pth(root / 'blocks' / f'{item["id"]:012d}.pth')['embeddings']
    cos['blocks_whole_and_4'] = _min_cos(emb_cpu, emb_card[:1 + n_check])
    # the first image's whole-image embedding, with the resize taps the
    # globals CLI's batch used (the largest of its images')
    gpreps = [globals_.prepare(dict(
        id=id_, output=None, image=(im := objects._dataset.load(id_)),
        height=im.shape[0], width=im.shape[1])) for id_ in data['ids']]
    k_glob = bucket(max(p['ksize'] for p in gpreps), (5, 9, 13, 21))
    emb_cpu = cpu_steps.globals_step(
        [gpreps[0]['image']], gpreps[0]['meta'][None], k_glob).float().numpy()
    emb_card = load_pth(root / 'globals' / f'{data["ids"][0]:012d}.pth')[None]
    cos['globals_1'] = _min_cos(emb_cpu, emb_card)
    log(json.dumps({'cpu_fp32_vs_card_bf16_min_cosine': cos,
                    'split_vs_fused_min_cosine': split_vs_fused}))
    if min(cos.values()) < 0.99 or split_vs_fused < 0.99:
        raise AssertionError(f'cosine below 0.99: {cos}, split vs fused {split_vs_fused}')

    # steady-state rate: the same pipelines again into fresh directories
    rates = {}
    for name, pipe in (('objects', objects), ('globals', globals_), ('blocks', blocks)):
        pipe.config.val.dataloader.dataset.output_dir = str(root / f'{name}_timed')
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        rates[name] = N_IMAGES / (time.perf_counter() - t0)
    for name, attr in steps_of.items():
        setattr(E.OakeSteps, attr, originals[name])
    launches = dict(l_obj)
    for k in l_obj:
        launches[k] = l_obj[k] + l_glob[k] + l_blocks[k] + l_split[k]
    res = dict(images=N_IMAGES, proposals_per_image=N_PROPOSALS,
               objects_img_s=rates['objects'], globals_img_s=rates['globals'],
               blocks_img_s=rates['blocks'], cpu_fp32_min_cosine=cos,
               split_vs_fused_min_cosine=split_vs_fused,
               split_dispatch_ms=split_ms, split_crops=nb,
               fused_dispatch_ms=fused_ms, fused_crops=nb + 1, card=card,
               launches=launches, dispatches=dict(dispatches, split=1))
    log(json.dumps({'main_path': res}))
    return res


# ---------------------------------------------------------------------------
# Phase 5: the ViLD prompt CLI at full text-tower width
# ---------------------------------------------------------------------------

N_MERGES = 49152 - 256 - 2  # the merges of a CLIP vocabulary (49408 ids)


def openai_state_dict(vit: dict, text: dict) -> dict:
    """The port's ViT and text parameter trees as an OpenAI CLIP state dict
    (``ViT-B-32.pt``'s keys and layouts: ``nn.Linear`` weights ``(out,
    in)``)."""
    state = {}

    def put_ln(key, ln):
        state[f'{key}.weight'], state[f'{key}.bias'] = ln['scale'], ln['bias']

    def put_blocks(prefix, blocks):
        for i, b in enumerate(blocks):
            p = f'{prefix}transformer.resblocks.{i}.'
            put_ln(p + 'ln_1', b['ln_1'])
            put_ln(p + 'ln_2', b['ln_2'])
            for key, (group, w, bias) in {
                'attn.in_proj': ('attn', 'qkv_w', 'qkv_b'),
                'attn.out_proj': ('attn', 'out_w', 'out_b'),
                'mlp.c_fc': ('mlp', 'fc_w', 'fc_b'),
                'mlp.c_proj': ('mlp', 'proj_w', 'proj_b'),
            }.items():
                name = p + key + ('_weight' if key == 'attn.in_proj' else '.weight')
                state[name] = b[group][w].T
                state[name.replace('weight', 'bias')] = b[group][bias]

    state['visual.conv1.weight'] = vit['conv1']
    for key in ('class_embedding', 'positional_embedding', 'proj'):
        state[f'visual.{key}'] = vit[key]
    put_ln('visual.ln_pre', vit['ln_pre'])
    put_ln('visual.ln_post', vit['ln_post'])
    put_blocks('visual.', vit['blocks'])
    state['token_embedding.weight'] = text['token_embedding']
    state['positional_embedding'] = text['positional_embedding']
    state['text_projection'] = text['text_projection']
    put_ln('ln_final', text['ln_final'])
    put_blocks('', text['blocks'])
    return {k: v.contiguous() for k, v in state.items()}


def write_bpe(path: pathlib.Path, seed: int = 0) -> None:
    """A gzipped merges file with a CLIP vocabulary's 48,894 merges: pairs
    of byte symbols (the second one word-final or not), drawn from
    ``seed``, so that the tokenizer has all 49,408 ids."""
    from oadp_torch.models.tokenizer import bytes_to_unicode

    symbols = list(bytes_to_unicode().values())
    seconds = symbols + [c + '</w>' for c in symbols]
    order = np.random.RandomState(seed).permutation(len(symbols) * len(seconds))
    lines = [f'{symbols[i // len(seconds)]} {seconds[i % len(seconds)]}'
             for i in order[:N_MERGES]]
    with gzip.open(path, 'wt', encoding='utf-8') as f:
        f.write('\n'.join(['#version: synthetic', *lines]) + '\n')


def vild_path(out: pathlib.Path) -> dict:
    """The ViLD prompt CLI on the card at full text-tower width, its record
    (``out``, phase 6's prompt file) checked; the builder on a few names
    against the CPU; the native matcher."""
    from oadp_torch.base import coco, lvis
    from oadp_torch.dp import coco_eval as CE
    from oadp_torch.models import clip as C
    from oadp_torch.models.tokenizer import SimpleTokenizer
    from oadp_torch.native import load_library
    from oadp_torch.prompts import vild
    from oadp_torch.utils import load_pth

    repo = pathlib.Path(__file__).resolve().parent
    names = sorted(set(coco.all_ + lvis.all_))
    cfg = C.TextConfig()
    with tempfile.TemporaryDirectory(dir=repo / 'build') as tmp:
        root = pathlib.Path(tmp)
        ckpt, bpe = root / 'ViT-B-32.pt', root / 'bpe.txt.gz'
        gen = torch.Generator().manual_seed(0)
        state = openai_state_dict(C.init_vit_params(gen), C.init_text_params(gen, cfg))
        state = {k: v.half() for k, v in state.items()}
        torch.save(state, ckpt)
        write_bpe(bpe)

        encode_s = []
        build = vild.build_vild_prompts

        def timed_build(*a, **k):
            t0 = time.perf_counter()
            emb = build(*a, **k)  # numpy: the device's work is done
            encode_s.append(time.perf_counter() - t0)
            return emb

        vild.build_vild_prompts = timed_build
        try:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            vild.main(['--checkpoint', str(ckpt), '--bpe', str(bpe), '--output', str(out),
                       '--device', 'cuda'])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        finally:
            vild.build_vild_prompts = build
        launches = launch_counts()
        log(json.dumps({'launches': {'vild': launches}}))
        if any(launches.values()):
            raise AssertionError(f'vild: the text encoder launched fused kernels {launches}')

        rec = load_pth(out)
        emb = np.asarray(rec['embeddings'])
        norms = np.linalg.norm(emb.astype(np.float64), axis=-1)
        if (list(rec['names']) != names or len(names) != 1217 or emb.shape != (1217, 512)
                or emb.dtype != np.float32 or not np.isfinite(emb).all()):
            raise AssertionError(f'vild record: {len(rec["names"])} names, {emb.shape} {emb.dtype}')
        # a mean of unit rows: norm <= 1, up to the fp32 rounding of the mean
        if not (norms > 0).all() or norms.max() > 1 + 1e-6:
            raise AssertionError(f'vild row norms in [{norms.min()}, {norms.max()}]')

        # the card against the CPU, fp32, on the same parameters
        tok = SimpleTokenizer(bpe)
        text_cpu = C.load_openai_text_state_dict(state)
        text_card = C.map_params(text_cpu, lambda t: t.cuda())
        few = dict(names=names[:16], batch_size=16, prompts=vild.PROMPTS[:3])
        card_few = build(text_card, tok, **few)
        cpu_few = build(text_cpu, tok, **few)
        few_cos = _min_cos(card_few, cpu_few)
        few_err = float(np.abs(card_few - cpu_few).max())
        if few_cos < 0.99999 or few_err > 2e-4:
            raise AssertionError(f'vild card vs CPU: cosine {few_cos}, max abs {few_err}')

    lib = load_library('cocoeval_match')
    if lib is None:
        raise AssertionError('the native COCO matcher did not build')
    rng = np.random.default_rng(0)
    for _ in range(200):
        nd, ng = int(rng.integers(1, 40)), int(rng.integers(1, 20))
        ious = rng.random((nd, ng))
        g_ignore = np.sort(rng.random(ng) < 0.3)  # ignored gts last
        iscrowd = (rng.random(ng) < 0.2) & g_ignore
        for got, want in zip(CE._match_pairs(ious, g_ignore, iscrowd),
                             CE._match_pairs_py(ious, g_ignore, iscrowd)):
            np.testing.assert_array_equal(got, want)

    rows = len(names) * len(vild.PROMPTS)
    batches = math.ceil(len(names) / 256) * len(vild.PROMPTS)
    res = dict(names=len(names), templates=len(vild.PROMPTS), rows=rows, batches=batches,
               cli_s=cli_s, encode_s=encode_s[0], rows_per_s=rows / encode_s[0],
               ms_per_batch=1e3 * encode_s[0] / batches, min_row_norm=float(norms.min()),
               max_row_norm=float(norms.max()), card_vs_cpu_min_cosine=few_cos,
               card_vs_cpu_max_abs=few_err, native_matcher_cases=200, launches=launches)
    log(json.dumps({'vild_path': res}))
    return res


# ---------------------------------------------------------------------------
# Phase 6: DP inference (python -m oadp_torch.dp.test) at full OV-COCO width
# ---------------------------------------------------------------------------

# (w, h) of the synthetic images: COCO sizes, landscape and portrait
DP_SIZES = [(640, 480), (480, 640), (640, 427), (427, 640), (500, 375), (375, 500),
            (640, 512), (612, 612)]
N_LVIS_IMAGES = 2


def mmdet_state_dict(seed: int = 0, base: int = 64, fpn: int = 256, fc: int = 1024,
                     emb: int = 512) -> dict:
    """A random mmdet-layout detector checkpoint (ResNet-50 at ``base``
    channels, FPN, RPN, the bbox and object heads, the mask head), drawn from
    ``seed``: He-normal convs, Xavier fcs, batch norms with random affines and
    running statistics (the last of each bottleneck small, so that the
    residual stream stays bounded through 16 blocks)."""
    from oadp_torch.models.resnet import STAGE_BLOCKS

    gen = torch.Generator().manual_seed(seed)
    state = {}

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen) * std

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen)

    def conv(key, c_out, c_in, k, bias=False):
        state[f'{key}.weight'] = randn(c_out, c_in, k, k, std=(2.0 / (c_in * k * k)) ** 0.5)
        if bias:
            state[f'{key}.bias'] = randn(c_out, std=0.01)

    def bn(key, c, scale=(0.5, 1.0)):
        state[f'{key}.weight'] = uniform(*scale, c)
        state[f'{key}.bias'] = randn(c, std=0.1)
        state[f'{key}.running_mean'] = randn(c, std=0.1)
        state[f'{key}.running_var'] = uniform(0.5, 2.0, c)

    def linear(key, c_out, c_in, std=None):
        std = (2.0 / (c_in + c_out)) ** 0.5 if std is None else std
        state[f'{key}.weight'] = randn(c_out, c_in, std=std)
        state[f'{key}.bias'] = randn(c_out, std=0.01)

    conv('backbone.conv1', base, 3, 7)
    bn('backbone.bn1', base)
    c_in = base
    for i, n in enumerate(STAGE_BLOCKS[50]):
        c_mid = base * 2 ** i
        for b in range(n):
            p = f'backbone.layer{i + 1}.{b}'
            conv(f'{p}.conv1', c_mid, c_in, 1)
            bn(f'{p}.bn1', c_mid)
            conv(f'{p}.conv2', c_mid, c_mid, 3)
            bn(f'{p}.bn2', c_mid)
            conv(f'{p}.conv3', 4 * c_mid, c_mid, 1)
            bn(f'{p}.bn3', 4 * c_mid, scale=(0.1, 0.3))
            if b == 0:
                conv(f'{p}.downsample.0', 4 * c_mid, c_in, 1)
                bn(f'{p}.downsample.1', 4 * c_mid)
            c_in = 4 * c_mid
    for i in range(4):
        conv(f'neck.lateral_convs.{i}.conv', fpn, base * 4 * 2 ** i, 1)
        bn(f'neck.lateral_convs.{i}.bn', fpn)
        conv(f'neck.fpn_convs.{i}.conv', fpn, fpn, 3)
        bn(f'neck.fpn_convs.{i}.bn', fpn)
    state['rpn_head.rpn_conv.weight'] = randn(fpn, fpn, 3, 3, std=0.01)
    state['rpn_head.rpn_conv.bias'] = torch.zeros(fpn)
    for name, c_out in (('rpn_cls', 3), ('rpn_reg', 12)):
        state[f'rpn_head.{name}.weight'] = randn(c_out, fpn, 1, 1, std=0.01)
        state[f'rpn_head.{name}.bias'] = torch.zeros(c_out)
    for head in ('bbox_head', '_object_head'):
        p = f'roi_head.{head}'
        for i in range(4):
            conv(f'{p}.shared_convs.{i}.conv', fpn, fpn, 3)
            bn(f'{p}.shared_convs.{i}.bn', fpn)
        linear(f'{p}.shared_fcs.0', fc, fpn * 7 * 7)
        linear(f'{p}.fc_cls._linear', emb, fc)
        state[f'{p}.fc_cls._bg_embedding'] = randn(1, emb)
    linear('roi_head.bbox_head.fc_reg', 4, fc, std=0.001)
    for i in range(4):
        conv(f'roi_head.mask_head.convs.{i}.conv', fpn, fpn, 3, bias=True)
    state['roi_head.mask_head.upsample.weight'] = randn(fpn, fpn, 2, 2, std=(2.0 / (4 * fpn)) ** 0.5)
    state['roi_head.mask_head.upsample.bias'] = randn(fpn, std=0.01)
    conv('roi_head.mask_head.conv_logits', 1, fpn, 1, bias=True)
    return state


def write_dp_data(root: pathlib.Path, names: list[str], sizes: list, seed: int = 0,
                  lvis: bool = False) -> tuple[pathlib.Path, pathlib.Path]:
    """JPEGs at ``sizes`` and a COCO-layout annotation file over the
    categories ``names`` (ids 1..C in that order): 3-8 random boxes an
    image, each with a triangle polygon; with ``lvis``, LVIS's fields
    (frequencies, negative and not-exhaustive category lists)."""
    import PIL.Image

    rng = np.random.RandomState(seed)
    img_dir = root / 'images'
    img_dir.mkdir(parents=True)
    images, annotations = [], []
    for i, (w, h) in enumerate(sizes):
        id_ = i + 1
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h, (xx * yy) % 256], -1)
        arr = np.clip(base + rng.randint(-40, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        name = f'{id_:012d}.jpg'
        PIL.Image.fromarray(arr).save(img_dir / name, quality=90)
        info = dict(id=id_, file_name=name, width=w, height=h)
        if lvis:
            info.update(neg_category_ids=[int(c) + 1 for c in rng.choice(len(names), 5, False)],
                        not_exhaustive_category_ids=[])
        images.append(info)
        for _ in range(rng.randint(3, 9)):
            x0, y0 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
            bw, bh = rng.uniform(16, w * 0.4), rng.uniform(16, h * 0.4)
            annotations.append(dict(
                id=len(annotations) + 1, image_id=id_,
                category_id=int(rng.randint(len(names))) + 1, bbox=[x0, y0, bw, bh],
                area=bw * bh / 2, iscrowd=0,
                segmentation=[[x0, y0, x0 + bw, y0, x0 + bw / 2, y0 + bh]]))
    categories = [dict(id=i + 1, name=n, **(dict(frequency='rcf'[i % 3]) if lvis else {}))
                  for i, n in enumerate(names)]
    ann = root / 'annotations.json'
    ann.write_text(json.dumps(dict(images=images, annotations=annotations,
                                   categories=categories)))
    return img_dir, ann


def _dp_config(base: str, root: pathlib.Path, img_dir, ann, prompts, ckpt) -> pathlib.Path:
    """The repo's DP config with the synthetic val split, phase 5's prompt
    file, no ``ml_prompts`` file (random embeddings) and the random
    checkpoint as ``model.pretrained``, on the card."""
    from oadp_torch.utils import Config

    cfg = Config.load(base)
    cfg.model.update(prompts=str(prompts), ml_prompts=str(root / 'absent_ml.pth'),
                     pretrained=str(ckpt), device='cuda')
    cfg.validator.dataloader.dataset.update(ann_file=str(ann), img_prefix=str(img_dir))
    path = root / pathlib.Path(base).name
    cfg.dump(path)
    return path


def _check_detections(results: dict, dataset, max_dets: int) -> int:
    """Every image's records: finite boxes inside the image, known
    categories, at most ``max_dets``, scores non-increasing. Returns the
    number of detections."""
    n = 0
    for info in dataset.images:
        dets = results[info['id']]
        if not 0 < len(dets) <= max_dets:
            raise AssertionError(f'image {info["id"]}: {len(dets)} detections')
        box = np.asarray([d['bbox'] for d in dets], np.float64)
        score = np.asarray([d['score'] for d in dets])
        w, h = info['width'], info['height']
        if not (np.isfinite(box).all() and np.isfinite(score).all()):
            raise AssertionError(f'image {info["id"]}: non-finite detections')
        if ((box[:, :2] < -1e-3).any() or (box[:, 0] + box[:, 2] > w * (1 + 1e-4)).any()
                or (box[:, 1] + box[:, 3] > h * (1 + 1e-4)).any() or (box[:, 2:] < 0).any()):
            raise AssertionError(f'image {info["id"]}: a box outside the {w}x{h} image')
        if (np.diff(score) > 0).any():
            raise AssertionError(f'image {info["id"]}: scores not in descending order')
        labels = [dataset.cat2label[d['category_id']] for d in dets]
        if min(labels) < 0 or max(labels) >= len(dataset.cat_ids):
            raise AssertionError(f'image {info["id"]}: label out of range')
        n += len(dets)
    return n


def _rel_err(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> tuple[float, float]:
    """Max abs and max rel difference (rel over ``|want| > floor``)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    diff = (got - want).abs()
    keep = want.abs() > floor
    rel = (diff[keep] / want.abs()[keep]).max() if keep.any() else torch.tensor(0.0)
    return float(diff.max()), float(rel)


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)


def _check_full_width(config) -> None:
    """The OV-COCO detector at its published widths: ResNet-50 (64 base
    channels), FPN 256, the 4conv-1fc heads at 1024, 1000 proposals, 300
    detections, 65 classes."""
    got = (config.backbone.base_channels, config.backbone.stage_blocks, config.fpn_channels,
           config.bbox_head.fc_channels, config.rpn_test_max, config.rcnn_max_per_img,
           config.num_all)
    if got != (64, (3, 4, 6, 3), 256, 1024, 1000, 300, 65):
        raise AssertionError(f'not the full OV-COCO detector: {got}')


class _StageClock:
    """CUDA events around the stages of ``simple_test``: each stage
    function of the detector's modules is wrapped while the clock is
    entered, its calls' event pairs kept by stage name."""

    def __init__(self, stages):
        self.stages = stages  # (name, module, attribute)
        self.events: dict[str, list] = {name: [] for name, _, _ in stages}

    def __enter__(self):
        self.saved = [(m, a, getattr(m, a)) for _, m, a in self.stages]
        for (name, module, attr), (_, _, fn) in zip(self.stages, self.saved):
            setattr(module, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)

    def _wrap(self, name, fn):
        def timed_fn(*a, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **k)
            end.record()
            self.events[name].append((start, end))
            return out
        return timed_fn

    def ms(self, calls: int) -> dict:
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in ev) / calls
                for name, ev in self.events.items()}


class _NmsWatch:
    """While entered: the calls of ``ops/nms.py:greedy_keep_sorted`` by
    device (on the card, one ``greedy_nms`` launch each), the calls of the
    plain pass loop ``_greedy_keep`` on a CUDA tensor (none: the card takes
    the kernel) and the pass counts of those on the CPU."""

    def __enter__(self):
        from oadp_torch.ops import nms as NMS

        self.module = NMS
        self.calls = {'cuda': 0, 'cpu': 0}
        self.plain_on_card, self.cpu_passes = 0, []
        self.saved = keep_fn, greedy = NMS.greedy_keep_sorted, NMS._greedy_keep
        self.launches0 = NMS.LAUNCHES['greedy_nms']

        def counted_keep(boxes, *a, **k):
            self.calls[boxes.device.type] += 1
            return keep_fn(boxes, *a, **k)

        def counted_greedy(sup, alive):
            keep, passes = greedy(sup, alive)
            if sup.is_cuda:
                self.plain_on_card += 1
            else:
                self.cpu_passes.append(passes)
            return keep, passes

        NMS.greedy_keep_sorted, NMS._greedy_keep = counted_keep, counted_greedy
        return self

    def __exit__(self, *exc):
        self.module.greedy_keep_sorted, self.module._greedy_keep = self.saved

    @property
    def launches(self) -> int:
        return self.module.LAUNCHES['greedy_nms'] - self.launches0


def _check_dp_launches(label: str, launches: dict, expected: int, watch: _NmsWatch) -> None:
    """A DP path's launch gates: no attention kernel, ``expected``
    ``greedy_nms`` launches (one an NMS call on the card), and no plain
    greedy pass loop on the card."""
    fused = {k: v for k, v in launches.items() if k != 'greedy_nms'}
    if (any(fused.values()) or launches['greedy_nms'] != expected
            or watch.calls['cuda'] != expected or watch.plain_on_card):
        raise AssertionError(
            f'{label}: launches {launches}, {expected} greedy_nms expected; NMS calls '
            f'{watch.calls}, plain pass loops on the card {watch.plain_on_card}')


def _time_simple_test(run, canvas, reps: int = 5) -> dict:
    """``run()`` (one ``simple_test`` call on the card, one image) timed by
    stage with CUDA events over ``reps`` warm calls (the NMS kernel's calls,
    nested in the proposal and detection stages, reported beside them), the
    device's busy time from ``torch.profiler`` over two more, and one more
    call with its NMS calls and ``greedy_nms`` launches counted (one RPN
    call and one ``multiclass_nms``, no plain pass loop on the card)."""
    from torch.profiler import ProfilerActivity, profile

    from oadp_torch.models import detector as DET
    from oadp_torch.models import heads as H
    from oadp_torch.models import mask_head as MH
    from oadp_torch.models import rpn as RPN
    from oadp_torch.ops import nms as NMS
    from oadp_torch.ops import roi_align as RA

    stages = (('backbone_fpn', DET, '_extract'), ('rpn_head', RPN, 'rpn_forward'),
              ('rpn_proposals_nms', RPN, 'rpn_proposals'),
              ('roi_align', RA, 'roi_align_fpn'), ('two_heads', H, 'convfc_forward'),
              ('multiclass_nms', NMS, 'multiclass_nms'), ('mask_head', MH, 'mask_head_forward'))
    nested = (('nms_kernel', NMS, 'greedy_keep_sorted'),)
    run()
    torch.cuda.synchronize()
    with _StageClock(stages + nested + (('simple_test', DET, 'simple_test'),)) as clock:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    stage_ms = clock.ms(reps)
    total = stage_ms.pop('simple_test')
    inner = {name: stage_ms.pop(name) for name, _, _ in nested}
    stage_ms['ensemble_decode_other'] = total - sum(stage_ms.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 2 / 1e3
    with _NmsWatch() as watch:
        run()
        torch.cuda.synchronize()
    counts = dict(calls=watch.calls['cuda'], launches=watch.launches,
                  plain_on_card=watch.plain_on_card)
    if counts != dict(calls=2, launches=2, plain_on_card=0):
        raise AssertionError(f'simple_test NMS: {counts}, want 2 calls and launches')
    return dict(canvas=canvas, simple_test_ms=total, wall_ms=wall_ms, stage_ms=stage_ms,
                nms_inner_ms=inner, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms, nms_per_call=counts)


def dp_path(card: str, prompts: pathlib.Path, root: pathlib.Path) -> dict:
    """DP inference through ``python -m oadp_torch.dp.test`` at full
    OV-COCO width (fp32, twice: the second run warm) and OV-LVIS Mask
    R-CNN width, with every launch count at 0 before and after; the stages
    of one ``simple_test`` call timed; the card against the CPU on one
    image; one bf16 pass against fp32. A third fp32 run writes DUMP records
    (phase 8's input)."""
    from oadp_torch.base import coco, lvis
    from oadp_torch.dp import builder as B
    from oadp_torch.dp import test as dp_test
    from oadp_torch.dp.datasets import BatchBuilder, CocoDetDataset, TestTransform
    from oadp_torch.dp.evaluator import DetEvaluator
    from oadp_torch.models import detector as DET
    from oadp_torch.models import heads as H
    from oadp_torch.models import rpn as RPN
    from oadp_torch.ops import nms as NMS
    from oadp_torch.ops.coder import clip_boxes, decode_deltas
    from oadp_torch.utils import load_pth

    repo = pathlib.Path(__file__).resolve().parent
    captured: dict = {}
    run_fn, metrics_fn, forward_fn = DetEvaluator.run, DetEvaluator._metrics, DetEvaluator.forward

    def timed_run(self, params, stats):
        t0 = time.perf_counter()
        out = run_fn(self, params, stats)
        captured['run_s'] = time.perf_counter() - t0
        return out

    def keep_results(self, results):
        captured['results'] = results
        t0 = time.perf_counter()
        out = metrics_fn(self, results)
        captured['metrics_s'] = time.perf_counter() - t0
        return out

    batches = [0]  # every run's loader batches

    def keep_outputs(self, params, stats, batch):
        out = forward_fn(self, params, stats, batch)
        captured.setdefault('outputs', []).append(out)
        batches[0] += 1
        return out

    res: dict = {'card': card}
    t_phase = time.perf_counter()
    ckpt = root / 'mmdet_r50_fpn.pth'
    torch.save({'state_dict': mmdet_state_dict(seed=0)}, ckpt)
    coco_img, coco_ann = write_dp_data(root / 'coco', list(coco.all_), DP_SIZES)
    lvis_img, lvis_ann = write_dp_data(root / 'lvis', list(lvis.all_),
                                       DP_SIZES[:N_LVIS_IMAGES], seed=1, lvis=True)
    coco_cfg = _dp_config(str(repo / 'configs/dp/oadp_ov_coco.py'), root, coco_img,
                          coco_ann, prompts, ckpt)
    dump_dir = root / 'dump'
    lvis_cfg = _dp_config(str(repo / 'configs/dp/oadp_ov_lvis.py'), root, lvis_img,
                          lvis_ann, prompts, ckpt)

    DetEvaluator.run, DetEvaluator._metrics, DetEvaluator.forward = (
        timed_run, keep_results, keep_outputs)
    torch.cuda.synchronize()
    reset_launches()
    watch = _NmsWatch().__enter__()
    try:
        walls = []
        for _ in range(2):  # cold, then warm
            captured.clear()
            t0 = time.perf_counter()
            metrics = dp_test.main([str(coco_cfg), 'none'])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        coco_results = captured['results']
        # the warm run's evaluator loop (inference and records) and its
        # COCO evaluation, inside the CLI's wall
        loop_s = captured['run_s'] - captured['metrics_s']
        coco_eval_s = captured['metrics_s']
        captured.clear()
        t0 = time.perf_counter()
        bf16_metrics = dp_test.main([str(coco_cfg), 'none', '--override',
                                     '.validator.bf16:True'])
        torch.cuda.synchronize()
        bf16_wall = time.perf_counter() - t0
        bf16_results = captured['results']
        # DUMP mode (fp32): the per-image logit records that phase 8
        # calibrates
        os.environ['DUMP'] = str(dump_dir)
        try:
            t0 = time.perf_counter()
            dump_metrics = dp_test.main([str(coco_cfg), 'none'])
            torch.cuda.synchronize()
            dump_s = time.perf_counter() - t0
        finally:
            del os.environ['DUMP']
        lvis_walls = []
        for _ in range(2):
            captured.clear()
            t0 = time.perf_counter()
            lvis_metrics = dp_test.main([str(lvis_cfg), 'none'])
            torch.cuda.synchronize()
            lvis_walls.append(time.perf_counter() - t0)
        lvis_results, lvis_outputs = captured['results'], captured['outputs']
        lvis_loop_s = captured['run_s'] - captured['metrics_s']
        lvis_eval_s = captured['metrics_s']
    finally:
        watch.__exit__()
        DetEvaluator.run, DetEvaluator._metrics, DetEvaluator.forward = (
            run_fn, metrics_fn, forward_fn)
    launches = launch_counts()
    log(json.dumps({'launches': {'dp': launches}, 'nms_calls': watch.calls}))
    # each loader batch (one image: the configs' test samples_per_gpu):
    # one RPN NMS, one multiclass_nms; OV-COCO run 4 times (fp32 twice,
    # bf16, DUMP), OV-LVIS twice
    if batches[0] != 4 * len(DP_SIZES) + 2 * N_LVIS_IMAGES:
        raise AssertionError(f'dp: {batches[0]} loader batches')
    _check_dp_launches('dp', launches, 2 * batches[0], watch)

    coco_ds = CocoDetDataset(str(coco_ann), str(coco_img), coco, test_mode=True)
    lvis_ds = CocoDetDataset(str(lvis_ann), str(lvis_img), lvis, test_mode=True)
    res['coco_detections'] = _check_detections(coco_results, coco_ds, 300)
    records = sorted(dump_dir.glob('*.pth'))
    if dump_metrics != {} or [p.name for p in records] != [
            f'{info["id"]:012d}.pth' for info in coco_ds.images]:
        raise AssertionError(f'DUMP run: metrics {dump_metrics}, records {records}')
    for path in records:
        rec = load_pth(path)
        n = len(rec['bboxes'])
        if (sorted(rec) != ['bbox_logits', 'bboxes', 'object_logits', 'objectness']
                or not 0 < n <= 1000 or rec['bbox_logits'].shape != (n, coco.num_all + 1)
                or rec['object_logits'].shape != (n, coco.num_all + 1)
                or not np.isfinite(rec['bboxes']).all()):
            raise AssertionError(f'DUMP record {path.name}: '
                                 f'{ {k: v.shape for k, v in rec.items()} }')
    res.update(dump_records=len(records), dump_s=dump_s, dump_dir=str(dump_dir),
               coco_config=str(coco_cfg))
    res['bf16_detections'] = _check_detections(bf16_results, coco_ds, 300)
    res['lvis_detections'] = _check_detections(lvis_results, lvis_ds, 300)
    for key in ('COCO_48_17_bbox_mAP_50', 'COCO_48_bbox_mAP_50', 'COCO_17_bbox_mAP_50'):
        if key not in metrics or key not in bf16_metrics:
            raise AssertionError(f'OV-COCO metrics lack {key}: {sorted(metrics)}')
    for key in ('lvis_bbox_APr', 'lvis_segm_APr', 'lvis_segm_AP'):
        if key not in lvis_metrics:
            raise AssertionError(f'OV-LVIS metrics lack {key}: {sorted(lvis_metrics)}')
    for out in lvis_outputs:
        m = out['masks']
        if (m.shape[1:] != (300, 28, 28) or not torch.isfinite(m).all()
                or m.min() < 0 or m.max() > 1):
            raise AssertionError(f'OV-LVIS masks: {tuple(m.shape)} in '
                                 f'[{float(m.min())}, {float(m.max())}]')
    res.update(
        images=len(DP_SIZES), cold_s=walls[0], warm_s=walls[1],
        img_s=len(DP_SIZES) / walls[1], loop_s=loop_s, loop_img_s=len(DP_SIZES) / loop_s,
        coco_eval_s=coco_eval_s, bf16_img_s=len(DP_SIZES) / bf16_wall,
        lvis_images=N_LVIS_IMAGES, lvis_ms_per_image=1e3 * lvis_walls[1] / N_LVIS_IMAGES,
        lvis_loop_ms_per_image=1e3 * lvis_loop_s / N_LVIS_IMAGES, lvis_eval_s=lvis_eval_s,
        lvis_cold_s=lvis_walls[0],
        metrics=metrics, bf16_metrics=bf16_metrics, lvis_metrics=lvis_metrics)
    log(json.dumps({'dp_cli': res}))

    # one batch (one landscape image) through simple_test, by stage
    from oadp_torch.utils import Config

    cfg = Config.load(coco_cfg)
    bundle_cpu = B.build_detector(cfg.model, coco)
    bundle = bundle_cpu.to(torch.device('cuda'))
    config = bundle.config
    _check_full_width(config)
    batch = BatchBuilder(num_all=coco.num_all, with_clip=False)(
        [TestTransform()(coco_ds[0])])
    canvas = tuple(batch['images'].shape[1:3])

    def inputs(device, dtype=torch.float32):
        images = torch.from_numpy(batch['images']).to(device)
        return {'images': DET.ingest_images(images, dtype),
                'img_hw': torch.from_numpy(batch['img_hw']).to(device)}

    anchors = {d: B.canvas_anchors(config, canvas, d) for d in ('cpu', 'cuda')}
    card_in = inputs('cuda')

    def run_card():
        with torch.inference_mode():
            return DET.simple_test(bundle.params, bundle.stats, card_in, config,
                                   anchors['cuda'])

    timing = _time_simple_test(run_card, canvas)
    log(json.dumps({'dp_simple_test': timing}))

    # the same for OV-LVIS (C = 1203, masks) on its first image
    lvis_bundle = B.build_detector(Config.load(lvis_cfg).model, lvis).to(torch.device('cuda'))
    lvis_batch = BatchBuilder(num_all=lvis.num_all, with_clip=False)(
        [TestTransform()(lvis_ds[0])])
    lvis_canvas = tuple(lvis_batch['images'].shape[1:3])
    lvis_in = {'images': DET.ingest_images(torch.from_numpy(lvis_batch['images']).cuda()),
               'img_hw': torch.from_numpy(lvis_batch['img_hw']).cuda()}
    lvis_anchors = B.canvas_anchors(lvis_bundle.config, lvis_canvas, 'cuda')

    def run_lvis():
        with torch.inference_mode():
            return DET.simple_test(lvis_bundle.params, lvis_bundle.stats, lvis_in,
                                   lvis_bundle.config, lvis_anchors)

    lvis_timing = _time_simple_test(run_lvis, lvis_canvas)
    log(json.dumps({'dp_lvis_simple_test': lvis_timing}))
    del lvis_bundle, lvis_in

    # the card against the CPU on the same image, fp32 (TF32 off)
    def pre_nms(b, data, device, proposals=None, capture=None):
        p, st = b.params, b.stats
        with torch.inference_mode():
            pyramid = DET._extract(p, st, data['images'], config)
            scores, deltas = RPN.rpn_forward(p['rpn'], pyramid)
            rpn_nms = RPN.batched_nms
            if capture is not None:
                RPN.batched_nms = lambda *a: capture.append(a) or rpn_nms(*a)
            try:
                props, _, valid = RPN.rpn_proposals(
                    scores, deltas, anchors[device], data['img_hw'],
                    nms_pre=config.rpn_test_nms_pre, max_per_img=config.rpn_test_max)
            finally:
                RPN.batched_nms = rpn_nms
            if proposals is not None:
                props, valid = (t.to(device) for t in proposals)
            flat = DET._roi_feats(pyramid, props)
            bl, reg, _ = H.convfc_forward(p['bbox_head'], st['bbox_head'], flat,
                                          config.bbox_head)
            ol, _, _ = H.convfc_forward(p['object_head'], st['object_head'], flat,
                                        config.object_head)
            probs = torch.where(valid[0][:, None], DET.ensemble(bl, ol, config), 0.0)
            boxes = clip_boxes(decode_deltas(props.reshape(-1, 4), reg,
                                             stds=config.bbox_reg_stds),
                               data['img_hw'][0])
        return torch.cat([s.flatten() for s in scores]), props, valid, probs, boxes

    cpu_in = inputs('cpu')
    t0 = time.perf_counter()
    card_logits, props, valid, card_probs, card_boxes = pre_nms(bundle, card_in, 'cuda')
    rpn_args = []
    cpu_logits, _, _, cpu_probs, cpu_boxes = pre_nms(
        bundle_cpu, cpu_in, 'cpu', proposals=(props.cpu(), valid.cpu()), capture=rpn_args)
    cmp = {}
    cmp['rpn_logits_max_abs'], cmp['rpn_logits_max_rel'] = _rel_err(card_logits, cpu_logits,
                                                                    1e-3)
    cmp['probs_max_abs'], cmp['probs_max_rel'] = _rel_err(card_probs, cpu_probs, 1e-4)
    cmp['boxes_max_abs'], _ = _rel_err(card_boxes, cpu_boxes)
    nms_args = dict(score_thr=config.rcnn_score_thr, iou_threshold=config.rcnn_nms_iou,
                    max_per_img=config.rcnn_max_per_img, num_classes=config.num_all)
    with torch.inference_mode(), _NmsWatch() as cpu_watch:
        cpu_nms = NMS.multiclass_nms(cpu_boxes, cpu_probs, **nms_args)
        card_nms = NMS.multiclass_nms(cpu_boxes.cuda(), cpu_probs.cuda(), **nms_args)
        cpu_rpn = NMS.batched_nms(*rpn_args[0])
        card_rpn = NMS.batched_nms(*(a.cuda() if torch.is_tensor(a) else a
                                     for a in rpn_args[0]))
    # the CPU's plain passes (multiclass_nms, then batched_nms)
    cmp['cpu_nms_passes'] = cpu_watch.cpu_passes
    if cpu_watch.plain_on_card or cpu_watch.launches != 2:
        raise AssertionError(f'dp card vs CPU NMS: {cpu_watch.launches} launches, '
                             f'{cpu_watch.plain_on_card} plain pass loops on the card')
    cmp['multiclass_nms_identical'] = all(
        torch.equal(a.cpu(), b) for a, b in zip(card_nms[1:], cpu_nms[1:]))
    cmp['multiclass_nms_kept'] = int(cpu_nms[3].sum())
    cmp['batched_nms_identical'] = all(
        torch.equal(a.cpu(), b) for a, b in zip(card_rpn, cpu_rpn))
    cmp['batched_nms_candidates'] = int(rpn_args[0][0].shape[-2])
    cmp['batched_nms_kept'] = int(cpu_rpn[1].sum())
    with torch.inference_mode():
        cpu_out = DET.simple_test(bundle_cpu.params, bundle_cpu.stats, cpu_in, config,
                                  anchors['cpu'])
    cmp['cpu_s'] = time.perf_counter() - t0
    card_out = run_card()
    want_ok = cpu_out['valid'][0].numpy()
    got_ok = card_out['valid'][0].cpu().numpy()
    want = cpu_out['dets'][0].numpy()[want_ok][:100]
    got = card_out['dets'][0].cpu().numpy()[got_ok]
    want_l = cpu_out['labels'][0].numpy()[want_ok][:100]
    got_l = card_out['labels'][0].cpu().numpy()[got_ok]
    iou = _box_iou(want[:, :4], got[:, :4])
    match = ((want_l[:, None] == got_l[None]) & (iou >= 0.99)
             & (np.abs(want[:, None, 4] - got[None, :, 4]) <= 1e-3)).any(1)
    cmp['top100_matched'] = float(match.mean()) if len(match) else 0.0
    cmp['cpu_top'] = int(len(match))
    log(json.dumps({'dp_card_vs_cpu': cmp}))
    if (cmp['probs_max_rel'] > 1e-3 or not cmp['multiclass_nms_identical']
            or not cmp['batched_nms_identical'] or cmp['top100_matched'] < 0.95
            or cmp['cpu_top'] < 100):
        raise AssertionError(f'dp card vs CPU: {cmp}')

    # bf16 activations on the fp32 run's proposals: the pre-NMS probs
    bf16_in = inputs('cuda', torch.bfloat16)
    with torch.inference_mode():
        pyramid = DET._extract(bundle.params, bundle.stats, bf16_in['images'], config)
        flat = DET._roi_feats(pyramid, props)
        bl, _, _ = H.convfc_forward(bundle.params['bbox_head'], bundle.stats['bbox_head'],
                                    flat, config.bbox_head)
        ol, _, _ = H.convfc_forward(bundle.params['object_head'],
                                    bundle.stats['object_head'], flat, config.object_head)
        bf16_probs = torch.where(valid[0][:, None], DET.ensemble(bl, ol, config), 0.0)
    ok = valid[0]
    a, b = bf16_probs[ok].double(), card_probs[ok].double()
    bf16 = dict(probs_cosine=float(F.cosine_similarity(a.flatten(), b.flatten(), 0)),
                probs_row_min_cosine=float(F.cosine_similarity(a, b, 1).min()),
                probs_max_abs=float((a - b).abs().max()))
    log(json.dumps({'dp_bf16_vs_fp32': bf16}))
    if bf16['probs_cosine'] < 0.999:
        raise AssertionError(f'dp bf16 vs fp32: {bf16}')
    res.update(simple_test=timing, lvis_simple_test=lvis_timing, card_vs_cpu=cmp,
               bf16_vs_fp32=bf16, launches=launches, phase_s=time.perf_counter() - t_phase)
    return res


# ---------------------------------------------------------------------------
# Phase 7: DP training (python -m oadp_torch.dp.train) at full OV-COCO width
# ---------------------------------------------------------------------------

TRAIN_ITERS, RESUME_AT, TIMED_FROM = 20, 10, 5
PROFILED = (14, 18)  # the resumed run's torch.profiler window [start, stop)
TRAIN_STEP = 300  # the card-vs-CPU step: past the distillation warm-ups' start


def write_train_ann(path: pathlib.Path, names: list[str], n_bases: int, seed: int = 0) -> None:
    """A COCO train annotation file for phase 4's images (``SIZES``, ids
    1..N): 3-8 random boxes an image over the first ``n_bases`` of the
    categories ``names`` (ids 1..C in that order)."""
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i, (w, h) in enumerate(SIZES[:N_IMAGES]):
        images.append(dict(id=i + 1, file_name=f'{i + 1:012d}.jpg', width=w, height=h))
        for _ in range(rng.randint(3, 9)):
            x0, y0 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
            bw, bh = rng.uniform(16, w * 0.4), rng.uniform(16, h * 0.4)
            annotations.append(dict(id=len(annotations) + 1, image_id=i + 1,
                                    category_id=int(rng.randint(n_bases)) + 1,
                                    bbox=[x0, y0, bw, bh], area=bw * bh, iscrowd=0))
    categories = [dict(id=i + 1, name=n) for i, n in enumerate(names)]
    path.write_text(json.dumps(dict(images=images, annotations=annotations,
                                    categories=categories)))


def _train_config(repo: pathlib.Path, root: pathlib.Path, oake: pathlib.Path, dp: pathlib.Path,
                  prompts: pathlib.Path) -> pathlib.Path:
    """``configs/dp/oadp_ov_coco.py`` on the card with phase 4's images, their
    OAKE records and a train annotation file, phase 6's checkpoint as
    ``load_from`` and its images as the validator's, phase 5's prompts, 20
    iterations with checkpoints every 10, a log every 5, no in-train eval."""
    from oadp_torch.base import coco
    from oadp_torch.utils import Config

    ann = root / 'train.json'
    write_train_ann(ann, list(coco.all_), coco.num_bases)
    cfg = Config.load(str(repo / 'configs/dp/oadp_ov_coco.py'))
    cfg.model.update(prompts=str(prompts), ml_prompts=str(root / 'absent_ml.pth'), device='cuda')
    cfg.trainer.dataloader.dataset.update(
        ann_file=str(ann), img_prefix=str(oake / 'images'),
        clip_features=dict(globals_=str(oake / 'globals'), blocks=str(oake / 'blocks'),
                           objects=str(oake / 'objects')))
    cfg.trainer.update(load_from=str(dp / 'mmdet_r50_fpn.pth'), seed=0)
    cfg.trainer.runner.max_iters = TRAIN_ITERS
    cfg.trainer.checkpoint_config.update(by_epoch=False, interval=RESUME_AT)
    cfg.trainer.log_config.interval = 5
    cfg.trainer.evaluation.interval = 10 ** 9
    cfg.validator.dataloader.dataset.update(ann_file=str(dp / 'coco' / 'annotations.json'),
                                            img_prefix=str(dp / 'coco' / 'images'))
    path = root / 'oadp_ov_coco_train.py'
    cfg.dump(path)
    return path


class _StepClock(_StageClock):
    """CUDA events around each train step and, from step ``TIMED_FROM`` on,
    around the stage functions it calls (``nested``: timed apart, inside
    another stage), with the ``greedy_nms`` launches of those steps
    counted."""

    def __init__(self, stages, nested=()):
        super().__init__(stages + nested)
        self.nested = [name for name, _, _ in nested]
        self.steps: list = []
        self.launches: list[int] = []
        self.timed = False

    def __enter__(self):
        from oadp_torch.dp import trainer as TR
        from oadp_torch.ops import nms as NMS

        super().__enter__()
        self.saved.append((TR.Trainer, '_step_for', TR.Trainer._step_for))
        step_for = TR.Trainer._step_for
        clock = self

        def timed_step_for(trainer, canvas, epoch_len):
            step_fn, anchors = step_for(trainer, canvas, epoch_len)

            def step(*a, **k):
                clock.timed = len(clock.steps) >= TIMED_FROM
                launches = NMS.LAUNCHES['greedy_nms']
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = step_fn(*a, **k)
                end.record()
                clock.steps.append((start, end))
                if clock.timed:
                    clock.launches.append(NMS.LAUNCHES['greedy_nms'] - launches)
                return out
            return step, anchors

        TR.Trainer._step_for = timed_step_for
        return self

    def _wrap(self, name, fn):
        timed_fn = super()._wrap(name, fn)

        def maybe_timed(*a, **k):
            return (timed_fn if self.timed else fn)(*a, **k)
        return maybe_timed

    def result(self) -> dict:
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in self.steps]
        timed = ms[TIMED_FROM:]
        n = len(timed)
        stage = self.ms(n)
        inner = {name: stage.pop(name) for name in self.nested}
        return dict(step_ms=ms, timed_steps=n, ms_per_step=float(np.median(timed)),
                    mean_ms_per_step=float(np.mean(timed)), stage_ms=stage,
                    stage_sum_ms=sum(stage.values()), nested_ms=inner,
                    nms_launches_per_step=sum(self.launches) / n)


def _log_lines(path: pathlib.Path) -> dict[int, dict]:
    """The ``iter`` lines of a train log: step -> {lr, total, metrics}."""
    out = {}
    for line in path.read_text().splitlines():
        if ' lr ' not in line or 'iter ' not in line:
            continue
        head, inner = line.split('(', 1)
        words = head.split()
        step = int(words[words.index('iter') + 1].split('/')[0])
        vals = inner.split(')')[0].split()
        out[step] = dict(lr=float(words[words.index('lr') + 1]),
                         total=float(words[words.index('total') + 1]),
                         **{k: float(v) for k, v in zip(vals[0::2], vals[1::2])})
    return out


def _to_cpu(x):
    """A tensor, or a list or tuple of them, on the CPU."""
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _one_step(config, bundle, batch, draws, device, dtype, captured, proposals=None,
              rpn_inputs=None, stats_out=None):
    """One train step of ``bundle``'s params (copied) on ``device`` in
    ``dtype``: ``(losses, params before, params after, proposals)``, every
    sampled index set appended to ``captured``. ``proposals`` (the RPN's
    output of another run) replaces this run's RPN proposals; otherwise
    ``rpn_inputs`` (a list) takes the arguments of this run's
    ``rpn_proposals`` call, on the CPU. ``stats_out`` (a list) takes the
    step's new batch-norm statistics."""
    from oadp_torch.dp import builder as B
    from oadp_torch.dp import trainer as TR
    from oadp_torch.models import detector as DET
    from oadp_torch.models import rpn as RPN
    from oadp_torch.models.clip import map_params

    params = map_params(bundle.params, lambda t: t.detach().to(device).clone())
    stats = map_params(bundle.stats, lambda t: t.to(device).clone())
    before = map_params(params, torch.clone)
    trainer = TR.Trainer(bundle, config.trainer, None, '.', bf16=dtype == torch.bfloat16,
                         device=device)
    anchors = B.canvas_anchors(bundle.config, tuple(batch['images'].shape[1:3]), device)
    step_fn = TR.build_train_step(
        bundle.config, anchors, TR._lr_mult_tree(params, trainer.lr_rules),
        TR.trainable_mask_tree(params, bundle.config), base_lr=trainer.base_lr,
        milestones=trainer.milestones, momentum=trainer.momentum,
        weight_decay=trainer.weight_decay, warmup_iters=trainer.warmup_iters,
        warmup_ratio=trainer.warmup_ratio)
    sample, rpn_proposals = DET.random_sample, RPN.rpn_proposals
    kept = []

    def keep(u, assigned, num, frac):
        out = sample(u, assigned, num, frac)
        captured.append([t.cpu() for t in out])
        return out

    def props(*a, **k):
        if proposals is None and rpn_inputs is not None:
            rpn_inputs.append((_to_cpu(a), k))
        out = (rpn_proposals(*a, **k) if proposals is None
               else tuple(t.to(device) for t in proposals))
        kept.append([t.cpu() for t in out])
        return out

    DET.random_sample = RPN.random_sample = keep
    RPN.rpn_proposals = props
    try:
        params, new_stats, _, losses = step_fn(params, stats, TR.sgd_init(params),
                                               trainer.device_batch(batch), TRAIN_STEP,
                                               {k: v.to(device) for k, v in draws.items()})
    finally:
        DET.random_sample = RPN.random_sample = sample
        RPN.rpn_proposals = rpn_proposals
    if stats_out is not None:
        stats_out.append(new_stats)
    return losses, before, params, kept[0]


def _proposal_diff(cpu_props, card_props, cpu_in, card_in) -> dict:
    """The card's own RPN proposals against the CPU's (rows equal within
    1e-3, valid flags) and what sets them apart: the two devices' largest
    objectness difference over all anchors, the score gap between the two
    sides' proposals at each differing row, whether the card's proposal of
    such a row is elsewhere among the CPU's, and a replay of the CPU's
    ``rpn_proposals`` on the card's own inputs against the card's output."""
    from oadp_torch.models import rpn as RPN

    def rows(a, b):
        return (a[0] - b[0]).abs().amax(-1) <= 1e-3

    same = rows(card_props, cpu_props)
    replay = RPN.rpn_proposals(*card_in[0], **card_in[1])
    replay_same = rows(replay, card_props)
    noise = max(float((torch.sigmoid(a.double()) - torch.sigmoid(b.double())).abs().max())
                for a, b in zip(cpu_in[0][0], card_in[0][0]))
    diff = []
    for b, r in (~same).nonzero().tolist():
        card_box = card_props[0][b, r]
        diff.append(dict(
            row=r, card_score=float(card_props[1][b, r]), cpu_score=float(cpu_props[1][b, r]),
            score_gap=abs(float(card_props[1][b, r]) - float(cpu_props[1][b, r])),
            card_box_among_cpu=bool(((cpu_props[0][b] - card_box).abs().amax(-1)
                                     <= 1e-3).any())))
    return dict(rows_equal=int(same.sum()), rows=int(same.numel()),
                valid_equal=bool(torch.equal(card_props[2], cpu_props[2])),
                objectness_max_abs_diff=noise, differing_rows=diff,
                replay_rows_equal=int(replay_same.sum()),
                replay_valid_equal=bool(torch.equal(replay[2], card_props[2])))


def _step_diff(want_losses, got_losses, want, got, flags) -> dict:
    """Losses' max rel difference (over |loss| > 1e-5) and the trainable
    leaves' update cosines of two steps; ``want``/``got`` are ``(before,
    after)`` params."""
    rel = {}
    for k, v in want_losses.items():
        if k.startswith('loss'):
            w, g = float(v), float(got_losses[k])
            rel[k] = abs(g - w) / abs(w) if abs(w) > 1e-5 else 0.0
    cos = _update_cosines(*want, *got, flags)
    return dict(loss_max_rel=max(rel.values()), loss_rel=rel, update_min_cosine=min(cos),
                trainable_leaves=len(cos))


def _update_cosines(a_before, a_after, b_before, b_after, flags) -> list[float]:
    """Per trainable leaf: the cosine of the two updates ``after - before``."""
    from oadp_torch.dp.trainer import _leaves

    out = []
    for a0, a1, b0, b1, t in zip(*map(_leaves, (a_before, a_after, b_before, b_after, flags))):
        if not t:
            continue
        da = (a1 - a0).detach().double().cpu().flatten()
        db = (b1 - b0).detach().double().cpu().flatten()
        out.append(float(F.cosine_similarity(da, db, 0)) if da.norm() * db.norm() > 0
                   else float(torch.equal(da, db)))
    return out


def dp_train_path(card: str, root: pathlib.Path, oake: pathlib.Path, dp: pathlib.Path,
                  prompts: pathlib.Path) -> dict:
    """DP training through ``python -m oadp_torch.dp.train`` at full OV-COCO
    width on phase 4's images and OAKE records, bf16: 20 iterations straight
    (checkpoints at 10 and 20; steps and stages timed with CUDA events from
    step 5; peak memory), a resume from the iteration-10 checkpoint to 20
    whose logged losses are held to the straight run's (a ``torch.profiler``
    window over 4 of its steps for the device's idle share),
    ``python -m oadp_torch.dp.test`` on the trained checkpoint; the launch
    counts at 0 before and after. Then RoIAlign forward and backward at the
    step's shapes, and one step (fp32, TF32 off) on the card against the CPU
    from the same params, image and draws (the RCNN side on the CPU's
    proposals; the card's own proposals held to the CPU's and to the CPU's
    proposal code replayed on the card's RPN outputs), and in bf16."""
    from oadp_torch.base import coco, lvis
    from oadp_torch.dp import builder as B
    from oadp_torch.dp import test as dp_test
    from oadp_torch.dp import train as dp_train
    from oadp_torch.dp import trainer as TR
    from oadp_torch.dp.datasets import CocoDetDataset
    from oadp_torch.dp.evaluator import DetEvaluator
    from oadp_torch.dp.synthetic import make_train_batch
    from oadp_torch.models import detector as DET
    from oadp_torch.models import fpn as FP
    from oadp_torch.models import heads as H
    from oadp_torch.models import resnet as RN
    from oadp_torch.models import rpn as RPN
    from oadp_torch.ops import nms as NMS
    from oadp_torch.ops import roi_align as RA
    from oadp_torch.profile_kernels import measure
    from oadp_torch.utils import Config

    repo = pathlib.Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    cfg_path = _train_config(repo, root, oake, dp, prompts)
    cwd = os.getcwd()
    os.chdir(root)
    stages = (('backbone', RN, 'resnet_forward'), ('fpn', FP, 'fpn_forward_train'),
              ('rpn_head', RPN, 'rpn_forward'), ('rpn_loss_assign_sample', RPN, 'rpn_loss'),
              ('proposals_nms', RPN, 'rpn_proposals'), ('rcnn_sampling', DET, '_sample_rcnn'),
              ('roi_align', RA, 'roi_align_fpn'), ('three_heads', H, 'convfc_forward_train'),
              ('global_head', H, 'global_head_forward'), ('backward', TR, '_gradients'),
              ('sgd_update', TR, 'sgd_update'))
    prof_box: dict = {}
    start_prof, stop_prof = TR._start_profiler, TR._stop_profiler

    def start(device):
        torch.cuda.synchronize()
        prof_box['t0'] = time.perf_counter()
        prof_box['prof'] = start_prof(device)
        return prof_box['prof']

    def stop(prof, device, out_dir):
        torch.cuda.synchronize()
        prof_box['wall_ms'] = (time.perf_counter() - prof_box['t0']) * 1e3
        stop_prof(prof, device, out_dir)

    torch.cuda.synchronize()
    reset_launches()
    watch = _NmsWatch().__enter__()
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _StepClock(stages, (('nms_kernel', NMS, 'greedy_keep_sorted'),)) as clock:
            straight = dp_train.main(['smoke_train', str(cfg_path)])
        torch.cuda.synchronize()
        straight_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        timing = clock.result()
        work = root / 'work_dirs' / 'smoke_train'
        TR._start_profiler, TR._stop_profiler = start, stop
        try:
            t0 = time.perf_counter()
            with _StepClock(()) as res_clock:
                resumed = dp_train.main([
                    'smoke_resumed', str(cfg_path), '--override',
                    f".trainer.resume_from:'{work / f'ckpt_{RESUME_AT}.pth'}'",
                    f".trainer.profile:{{'start': {PROFILED[0]}, 'stop': {PROFILED[1]}, "
                    f"'dir': '{root / 'trace'}'}}"])
            torch.cuda.synchronize()
            resumed_s = time.perf_counter() - t0
            # the profiled steps' CUDA-event times (the resumed run starts at
            # RESUME_AT)
            profiled_ms = [s.elapsed_time(e) for s, e in
                           res_clock.steps[PROFILED[0] - RESUME_AT:PROFILED[1] - RESUME_AT]]
        finally:
            TR._start_profiler, TR._stop_profiler = start_prof, stop_prof
        captured = {}
        metrics_fn = DetEvaluator._metrics

        def keep_results(self, results):
            captured['results'] = results
            return metrics_fn(self, results)

        DetEvaluator._metrics = keep_results
        try:
            t0 = time.perf_counter()
            metrics = dp_test.main([str(cfg_path), str(work / 'latest.txt')])
            torch.cuda.synchronize()
            test_s = time.perf_counter() - t0
        finally:
            DetEvaluator._metrics = metrics_fn
        launches = launch_counts()
    finally:
        watch.__exit__()
        os.chdir(cwd)
    log(json.dumps({'launches': {'dp_train': launches}, 'nms_calls': watch.calls}))
    # one RPN NMS a train step (both images of its batch): the straight run
    # and the resumed one; then dp.test: one RPN NMS and one multiclass_nms
    # a loader batch of one image
    _check_dp_launches('dp_train', launches, (2 * TRAIN_ITERS - RESUME_AT)
                       + 2 * len(DP_SIZES), watch)

    # the runs' gates: finite logged losses, a resume that continues, frozen
    # leaves and the backbone's statistics unchanged, the rest moved
    logs = _log_lines(work / 'train.log')
    res_logs = _log_lines(root / 'work_dirs' / 'smoke_resumed' / 'train.log')
    if sorted(logs) != [5, 10, 15, 20] or sorted(res_logs) != [15, 20]:
        raise AssertionError(f'dp_train: logged steps {sorted(logs)}, resumed {sorted(res_logs)}')
    for step, vals in list(logs.items()) + list(res_logs.items()):
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f'dp_train: non-finite log at step {step}: {vals}')
    if (straight.step, resumed.step) != (TRAIN_ITERS, TRAIN_ITERS) or any(
            res_logs[s]['lr'] != logs[s]['lr'] for s in (15, 20)):
        raise AssertionError(f'dp_train: resume at {resumed.step} with lr '
                             f'{[res_logs[s]["lr"] for s in (15, 20)]} against '
                             f'{[logs[s]["lr"] for s in (15, 20)]}')
    # the resumed run's losses are the straight run's: params, momentum, the
    # generator and the loader position restored (1e-3 rel for the card's
    # atomic adds, 1e-4 abs for the log's 4 decimals)
    resume_diff, bad = {}, {}
    for s in (15, 20):
        for k, want in logs[s].items():
            if k == 'total' or k.startswith('loss'):
                d = resume_diff[f'{k}@{s}'] = abs(res_logs[s][k] - want)
                if d > 1e-3 * abs(want) + 1e-4:
                    bad[f'{k}@{s}'] = (want, res_logs[s][k])
    log(json.dumps({'dp_train_resume_abs_diff': resume_diff}))
    if bad:
        raise AssertionError(f'dp_train: resumed losses differ from the straight run: {bad}')
    cfg = Config.load(cfg_path)
    cfg.model.device = 'cpu'
    init = B.build_detector(cfg.model, coco, seed=0)
    init.load_pretrained(cfg.trainer.load_from)
    _check_full_width(init.config)
    flags = TR.trainable_mask_tree(init.params, init.config)
    final = TR.Trainer.restore(work / 'latest.txt')
    moves = {'frozen_changed': 0, 'trainable_unmoved': 0, 'trainable': 0, 'frozen': 0}
    for p0, p1, t in zip(*map(TR._leaves, (init.params, final.params, flags))):
        same = torch.equal(p0, p1)
        moves['trainable' if t else 'frozen'] += 1
        moves['trainable_unmoved' if t else 'frozen_changed'] += same if t else not same
    stats_moved = {name: sum(not torch.equal(a, b) for a, b in zip(
        TR._leaves(init.stats[name]), TR._leaves(final.stats[name])))
        for name in final.stats}
    stats_total = {name: len(TR._leaves(final.stats[name])) for name in final.stats}
    log(json.dumps({'dp_train_leaves': moves, 'stats_moved': stats_moved,
                    'stats_total': stats_total}))
    if (moves['frozen_changed'] or moves['trainable_unmoved'] or stats_moved['backbone']
            or any(stats_moved[k] != stats_total[k] for k in stats_total if k != 'backbone')):
        raise AssertionError(f'dp_train leaves: {moves}, stats moved {stats_moved}')
    val = CocoDetDataset(str(dp / 'coco' / 'annotations.json'), str(dp / 'coco' / 'images'),
                         coco, test_mode=True)
    n_dets = _check_detections(captured['results'], val, 300)
    if 'COCO_48_17_bbox_mAP_50' not in metrics:
        raise AssertionError(f'dp.test on the trained checkpoint: {sorted(metrics)}')

    # the device's idle share over the resumed run's profiled steps: against
    # their wall (which holds the profiler's own host work), their CUDA-event
    # times, and as many unprofiled median steps of the straight run
    prof = prof_box['prof']
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    n_prof = PROFILED[1] - PROFILED[0]
    window = dict(steps=n_prof, wall_ms=prof_box['wall_ms'], device_busy_ms=busy_ms,
                  device_idle_share=1 - busy_ms / prof_box['wall_ms'],
                  step_event_ms=profiled_ms,
                  idle_share_of_step_events=1 - busy_ms / sum(profiled_ms),
                  idle_share_of_unprofiled_median=1 - busy_ms / (n_prof * timing['ms_per_step']))

    # RoIAlign at the step's shapes: a bf16 pyramid of 2 landscape images and
    # 2 x (512 + 512 + 128) RoIs, forward and backward (the scatter-add)
    gen = torch.Generator(device='cuda').manual_seed(0)
    batch_cfg = cfg.trainer.dataloader.batch
    canvas, c = tuple(batch_cfg.canvas), init.config.fpn_channels
    pyramid = [torch.randn(2, c, -(-canvas[0] // s), -(-canvas[1] // s), generator=gen,
                           device='cuda', dtype=torch.bfloat16).requires_grad_(True)
               for s in (4, 8, 16, 32, 64)]
    n_rois = init.config.rcnn_samples + batch_cfg.max_objects + batch_cfg.max_blocks
    xy = torch.rand(2, n_rois, 2, generator=gen, device='cuda') * torch.tensor(
        [canvas[1] * 0.8, canvas[0] * 0.8], device='cuda')
    wh = 8 + torch.rand(2, n_rois, 2, generator=gen, device='cuda') * canvas[0] * 0.5
    rois = torch.cat([xy, xy + wh], -1)
    grad_out = torch.randn(2, n_rois, c, 7, 7, generator=gen, device='cuda',
                           dtype=torch.bfloat16)

    def roi_fwd():
        return RA.roi_align_fpn(pyramid, rois)

    def roi_fwd_bwd():
        torch.autograd.grad(RA.roi_align_fpn(pyramid, rois), pyramid[:4], grad_out)

    fwd_ms, fwd_bwd_ms = (measure(fn, 5, profiled=False)['events_ms']
                          for fn in (roi_fwd, roi_fwd_bwd))
    roi_align = dict(rois=2 * n_rois, forward_ms=fwd_ms, backward_ms=fwd_bwd_ms - fwd_ms)
    del pyramid, grad_out

    # one step on the card against the CPU: fp32 (TF32 off), the same params,
    # one image and the same draws; then the card's step in bf16
    cfg.trainer.dataloader['samples_per_gpu'] = 1
    batch = next(iter(dp_train.build_train_loader(cfg, coco, cfg.model).epoch(0)))
    n_anchors = sum(len(a) for a in B.canvas_anchors(init.config,
                                                     tuple(batch['images'].shape[1:3])))
    draws = DET.make_draws(torch.Generator().manual_seed(1), init.config, 1, n_anchors,
                           batch['gt_boxes'].shape[1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device('cuda')
    samples = {'cpu': [], 'card': []}
    rpn_in = {'cpu': [], 'card': []}
    t0 = time.perf_counter()
    cpu_losses, *cpu, cpu_props = _one_step(cfg, init, batch, draws, torch.device('cpu'),
                                            torch.float32, samples['cpu'],
                                            rpn_inputs=rpn_in['cpu'])
    cpu_s = time.perf_counter() - t0
    # the card on the CPU's proposals: the RPN's scores sit in near-ties
    # (random weights), where rounding can reorder a few candidates before the
    # NMS; both sides' own proposals are compared apart
    card_losses, *card_run, card_props = _one_step(cfg, init, batch, draws, cuda, torch.float32,
                                               samples['card'], proposals=cpu_props)
    free_losses, *free, free_props = _one_step(cfg, init, batch, draws, cuda, torch.float32, [],
                                               rpn_inputs=rpn_in['card'])
    cmp = dict(samplers=len(samples['cpu']), samples_identical=len(samples['cpu']) == len(
        samples['card']) and all(torch.equal(a, b) for x, y in zip(samples['cpu'], samples['card'])
                                 for a, b in zip(x, y)), cpu_s=cpu_s,
               losses_cpu={k: float(v) for k, v in cpu_losses.items() if k != 'lr'},
               **_step_diff(cpu_losses, card_losses, cpu, card_run, flags))
    cmp['own_proposals'] = _proposal_diff(cpu_props, free_props, rpn_in['cpu'][0],
                                          rpn_in['card'][0])
    cmp['own_proposals'].update(
        {k: v for k, v in _step_diff(cpu_losses, free_losses, cpu, free, flags).items()
         if k != 'loss_rel'})
    log(json.dumps({'dp_train_card_vs_cpu': cmp}))
    own = cmp['own_proposals']
    if (not cmp['samples_identical'] or cmp['loss_max_rel'] > 1e-3
            or cmp['update_min_cosine'] < 0.999 or not own['valid_equal']
            or own['rows_equal'] < 0.99 * own['rows'] or not own['replay_valid_equal']
            or own['replay_rows_equal'] < 0.99 * own['rows']):
        raise AssertionError(f'dp_train card vs CPU: {cmp}')
    # bf16 on the card's fp32 proposals, against that fp32 step
    bf_losses, *bf, _ = _one_step(cfg, init, batch, draws, cuda, torch.bfloat16, [],
                                  proposals=free_props)
    bf_cos = _update_cosines(*free, *bf, flags)
    bf16 = dict(losses={k: float(v) for k, v in bf_losses.items() if k != 'lr'},
                update_min_cosine=min(bf_cos), update_median_cosine=float(np.median(bf_cos)))
    log(json.dumps({'dp_train_bf16_vs_fp32': bf16}))
    if not all(math.isfinite(v) for v in list(bf16['losses'].values()) + bf_cos):
        raise AssertionError(f'dp_train bf16: {bf16}')

    # one bf16 step with --override .model.backbone.norm_eval:False: every
    # backbone batch norm trains, the frozen stem's and layer1's too (as in
    # oadp_tpu), so the running statistics of every stage move
    bn_cfg = Config.load(cfg_path)
    bn_cfg.override({'.model.backbone.norm_eval': False, '.model.device': 'cpu'})
    bn_init = B.build_detector(bn_cfg.model, coco, seed=0)
    bn_init.load_pretrained(bn_cfg.trainer.load_from)
    if bn_init.config.backbone.norm_eval:
        raise AssertionError('model.backbone.norm_eval:False did not reach the backbone')
    bn_stats = []
    t0 = time.perf_counter()
    bn_losses, *_ = _one_step(bn_cfg, bn_init, batch, draws, cuda, torch.bfloat16, [],
                              stats_out=bn_stats)
    bn_s = time.perf_counter() - t0
    stages_moved = {
        stage: sum(not torch.equal(a, b.cpu()) for a, b in zip(
            TR._leaves(bn_init.stats['backbone'][stage]),
            TR._leaves(bn_stats[0]['backbone'][stage])))
        for stage in bn_init.stats['backbone']}
    stages_total = {stage: len(TR._leaves(bn_init.stats['backbone'][stage]))
                    for stage in bn_init.stats['backbone']}
    bn_train = dict(losses={k: float(v) for k, v in bn_losses.items() if k != 'lr'},
                    step_s=bn_s, backbone_stats_moved=stages_moved,
                    backbone_stats_total=stages_total)
    log(json.dumps({'dp_train_backbone_bn_train': bn_train}))
    if (not all(math.isfinite(v) for v in bn_train['losses'].values())
            or stages_moved != stages_total or len(stages_total) != 5):
        raise AssertionError(f'dp_train norm_eval=False step: {bn_train}')

    # one OV-LVIS Mask R-CNN step (C = 1203, masks) on the card, bf16, on a
    # synthetic batch at the LVIS train batch's sizes with a triangle polygon
    # in each gt box: finite losses, the mask head's leaves moved
    lvis_cfg = Config.load(dp / 'oadp_ov_lvis.py')
    lvis_cfg.model.device = 'cpu'
    lvis_init = B.build_detector(lvis_cfg.model, lvis, seed=0)
    lb = lvis_cfg.trainer.dataloader.batch
    lbatch = make_train_batch(1, tuple(lb.canvas), lvis.num_bases, lvis.num_all,
                              lvis_init.config.global_cls.embedding_dim,
                              n_gt=lb.max_gts, n_blocks=lb.max_blocks, n_objects=lb.max_objects,
                              n_gt_valid=6)
    polys = np.full((1, lb.max_gts, lb.max_polygon_parts, lb.max_polygon_verts, 2), -1e6,
                    np.float32)
    for j, (x0, y0, x1, y1) in enumerate(lbatch['gt_boxes'][0]):
        polys[0, j, 0] = [(x0, y0), (x1, y0)] + [(x0, y1)] * (lb.max_polygon_verts - 2)
    lbatch['gt_polygons'] = polys
    n_anchors = sum(len(a) for a in B.canvas_anchors(lvis_init.config, tuple(lb.canvas)))
    ldraws = DET.make_draws(torch.Generator().manual_seed(2), lvis_init.config, 1, n_anchors,
                            lb.max_gts)
    t0 = time.perf_counter()
    lvis_losses, lvis_before, lvis_after, _ = _one_step(lvis_cfg, lvis_init, lbatch, ldraws,
                                                        cuda, torch.bfloat16, [])
    lvis_s = time.perf_counter() - t0
    mask_moved = [not torch.equal(a.cpu(), b.detach().cpu()) for a, b in zip(
        TR._leaves(lvis_before['mask_head']), TR._leaves(lvis_after['mask_head']))]
    lvis_res = dict(losses={k: float(v) for k, v in lvis_losses.items() if k != 'lr'},
                    step_s=lvis_s, mask_leaves_moved=sum(mask_moved), mask_leaves=len(mask_moved))
    log(json.dumps({'dp_train_lvis': lvis_res}))
    if (not all(math.isfinite(v) for v in lvis_res['losses'].values())
            or not lvis_res['losses']['loss_mask'] > 0 or not all(mask_moved)):
        raise AssertionError(f'dp_train OV-LVIS step: {lvis_res}')

    res = dict(card=card, config='configs/dp/oadp_ov_coco.py', iterations=TRAIN_ITERS,
               batch=2, dtype='bfloat16', images=N_IMAGES,
               ms_per_step=timing['ms_per_step'], img_s=2e3 / timing['ms_per_step'],
               mean_ms_per_step=timing['mean_ms_per_step'], timed_steps=timing['timed_steps'],
               step_ms=timing['step_ms'], stage_ms=timing['stage_ms'],
               stage_sum_ms=timing['stage_sum_ms'],
               nms_kernel_ms_per_step=timing['nested_ms']['nms_kernel'],
               nms_launches_per_step=timing['nms_launches_per_step'], profiled=window,
               peak_memory_gb=peak_gb, roi_align=roi_align, straight_s=straight_s,
               resumed_s=resumed_s, test_s=test_s, test_detections=n_dets, test_metrics=metrics,
               last_log=logs[TRAIN_ITERS], resume_max_abs_diff=max(resume_diff.values()),
               leaves=moves, card_vs_cpu=cmp, bf16_vs_fp32=bf16,
               backbone_bn_train=bn_train, lvis_step=lvis_res,
               launches=launches, phase_s=time.perf_counter() - t_phase)
    return res


# ---------------------------------------------------------------------------
# Phase 8: calibration (python -m oadp_torch.dp.test_calibrate and
# python -m oadp_torch.dp.calibrate_sweep) on phase 6's DUMP records
# ---------------------------------------------------------------------------

VAL_IMAGES = 4952  # OV-COCO val: the split the reference's sweep scores
PERTURBED = (  # two settings off the defaults, inside the sweep's space
    dict(bbox_base_scaler=1.3, bbox_novel_scaler=0.4, bbox_novel_gamma=0.7,
         object_base_gamma=0.25, objectness_gamma=0.5),
    dict(bbox_base_gamma=0.8, object_base_scaler=0.6, object_novel_scaler=1.4,
         object_novel_gamma=0.2, objectness_gamma=1.0),
)


def calibration_path(card: str, config: pathlib.Path, dump: pathlib.Path,
                     root: pathlib.Path) -> dict:
    """The calibration trial and sweep CLIs on the card over phase 6's 8
    full-width OV-COCO DUMP records, with the launch counts at 0 before and
    checked after (one ``greedy_nms`` launch a 32-image ``rescore`` batch of
    a trial, no attention kernel, no plain greedy pass loop on the card); the card's
    ``CalibrationRunner`` against the CPU's on the same records at the
    defaults and two perturbed settings; one 32-image ``rescore`` batch
    (the 8 records 4 times) timed with CUDA events and ``torch.profiler``,
    its NMS launches counted and timed; the COCO evaluation's seconds for
    the 8 images and an estimate of a whole OV-COCO val trial."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from oadp_torch.dp import calibrate_sweep as SW
    from oadp_torch.dp import test_calibrate as TC
    from oadp_torch.ops import nms as NMS
    from oadp_torch.utils import Config

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    with _NmsWatch() as watch:
        t0 = time.perf_counter()
        line = TC.main(['smoke_calibration', str(config), str(dump)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sweep = SW.main([str(config), str(dump), '--trials', '5', '--seed', '0',
                         '--output', str(root / 'calibration.json')])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
    launches = launch_counts()
    log(json.dumps({'launches': {'calibration': launches}, 'nms_calls': watch.calls}))
    # one multiclass_nms a rescore batch (CalibrationRunner's 32 images) of
    # a trial: the CLI's trial, the sweep's 5
    _check_dp_launches('calibration', launches, -(-len(DP_SIZES) // 32) * (1 + 5), watch)

    cfg = Config.load(config)
    t0 = time.perf_counter()
    runner = TC.CalibrationRunner(cfg, str(dump))
    load_s = time.perf_counter() - t0
    cpu = TC.CalibrationRunner(cfg, str(dump), device='cpu')
    m = len(runner.image_ids)
    if runner.device.type != 'cuda' or runner.bboxes.shape != (m, 1000, 4) or m != 8:
        raise AssertionError(f'calibration runner: {runner.device}, '
                             f'{tuple(runner.bboxes.shape)}')
    settings = {'defaults': dict(TC.DEFAULT_PARAMS)}
    for i, p in enumerate(PERTURBED):
        settings[f'perturbed_{i + 1}'] = dict(TC.DEFAULT_PARAMS, **p)
    vs_cpu = {}
    for name, params in settings.items():
        got = [t.cpu() for t in runner.rescore_batch(params, 0, m)]
        with _NmsWatch() as cpu_watch:
            want = cpu.rescore_batch(params, 0, m)
        ok = want[3]
        same = all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
        boxes_equal = torch.equal(got[0][..., :4], want[0][..., :4])
        rel = float(((got[0][..., 4] - want[0][..., 4]).abs()
                     / want[0][..., 4].abs().clamp(min=1e-30))[ok].max())
        metrics, cpu_metrics = runner.run_trial(params), cpu.run_trial(params)
        vs_cpu[name] = dict(labels_rows_valid_identical=same, boxes_identical=boxes_equal,
                            detections=int(ok.sum()), score_max_rel=rel,
                            metrics_equal=metrics == cpu_metrics,
                            mAP_50=metrics['COCO_48_bbox_mAP_50'],
                            cpu_nms_passes_mean=float(np.mean(cpu_watch.cpu_passes)))
        for key in ('COCO_48_17_bbox_mAP_50', 'COCO_48_bbox_mAP_50', 'COCO_17_bbox_mAP_50'):
            if key not in metrics:
                raise AssertionError(f'calibration metrics lack {key}: {sorted(metrics)}')
    log(json.dumps({'calibration_card_vs_cpu': vs_cpu}))
    if not all(v['labels_rows_valid_identical'] and v['boxes_identical'] and v['metrics_equal']
               and v['score_max_rel'] <= 1e-5 and v['detections'] > 0
               for v in vs_cpu.values()):
        raise AssertionError(f'calibration card vs CPU: {vs_cpu}')
    if (line['metric'] != 'COCO_48_bbox_mAP_50' or not math.isfinite(line['value'])
            or line['params'] != TC.DEFAULT_PARAMS):
        raise AssertionError(f'calibration CLI line: {line}')
    history = json.loads((root / 'calibration.json').read_text())['history']
    if len(history) != 5 or history[0]['params'] != TC.DEFAULT_PARAMS or not all(
            math.isfinite(h['COCO_48_bbox_mAP_50']) for h in history):
        raise AssertionError(f'calibration sweep: {history}')

    # one 32-image rescore batch at full width: the 8 records 4 times
    params = dict(TC.DEFAULT_PARAMS)
    big = copy.copy(runner)
    for name in ('bboxes', 'bbox_logits', 'object_logits', 'objectness', 'valid'):
        setattr(big, name, torch.cat([getattr(runner, name)] * 4))
    big.image_ids = runner.image_ids * 4
    b = len(big.image_ids)

    def batch():
        return big.rescore_batch(params, 0, b)

    batch()
    torch.cuda.synchronize()
    reps = 5
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        batch()
    end.record()
    torch.cuda.synchronize()
    batch_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            batch()
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 2 / 1e3
    # the batch's NMS: one multiclass_nms, one launch, timed apart
    with _NmsWatch() as batch_watch, _StageClock(
            (('nms_kernel', NMS, 'greedy_keep_sorted'),)) as clock:
        batch()
        torch.cuda.synchronize()
    nms_counts = dict(calls=batch_watch.calls['cuda'], launches=batch_watch.launches,
                      plain_on_card=batch_watch.plain_on_card)
    if nms_counts != dict(calls=1, launches=1, plain_on_card=0):
        raise AssertionError(f'rescore batch NMS: {nms_counts}, want 1 call and launch')
    nms_ms = clock.ms(1)['nms_kernel']
    # a trial's two host parts: the batch's detection dicts (the median of
    # three runs: one run read 0.04-1.25 s on the same code and host), the
    # evaluation
    dict_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        big.detections(params)
        dict_runs.append(time.perf_counter() - t0)
    batch_with_dicts_s = float(np.median(dict_runs))
    dets = runner.detections(params)
    t0 = time.perf_counter()
    runner.evaluate(dets)
    eval_s = time.perf_counter() - t0
    return dict(
        card=card, records=m, proposals=1000, classes=runner.categories.num_all + 1, cli_s=cli_s,
        cli_line=line, sweep_trials=len(history), sweep_s=sweep_s,
        sweep_best=sweep['best_value'], load_s=load_s, card_vs_cpu=vs_cpu,
        rescore_batch=dict(images=b, ms=batch_ms, device_busy_ms=busy_ms,
                           device_idle_share=1 - busy_ms / batch_ms,
                           nms=nms_counts, nms_kernel_ms=nms_ms,
                           with_detection_dicts_s=batch_with_dicts_s,
                           with_detection_dicts_runs_s=dict_runs),
        coco_eval_s=eval_s, coco_eval_images=m, detections=len(dets),
        estimate_val_trial_s=VAL_IMAGES / b * batch_with_dicts_s + eval_s * VAL_IMAGES / m,
        estimate_basis=(f'ESTIMATE, not measured: {VAL_IMAGES}/{b} batches x the {b}-image '
                        f'batch with its detection dicts (median of three runs) + the COCO '
                        f'evaluation of the {m} '
                        f'images x {VAL_IMAGES}/{m} (random weights: 300 detections an '
                        'image, synthetic ground truth)'),
        launches=launches, phase_s=time.perf_counter() - t_phase)


def main() -> int:
    if not torch.cuda.is_available():
        log('chip_smoke: torch sees no CUDA device; nothing was run')
        return 1
    card = card_info()
    log(f'card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}')

    from oadp_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.library()
    log(json.dumps({'build_s': time.perf_counter() - t0,
                    'library_dir': str(cuda_lib.build_dir())}))

    log(json.dumps({'long_attention_build': long_attention_build()}))
    cuda_tests()
    # one directory for phases 4-7: phase 7 trains on phase 4's images and
    # OAKE records, from phase 6's checkpoint, with phase 5's prompts
    with tempfile.TemporaryDirectory(dir=pathlib.Path(__file__).resolve().parent / 'build') as tmp:
        tmp = pathlib.Path(tmp)
        for sub in ('oake', 'dp', 'train'):
            (tmp / sub).mkdir()
        main_path(card, tmp / 'oake')
        prompts = tmp / 'vild.pth'
        vild_path(prompts)
        dp = dp_path(card, prompts, tmp / 'dp')
        log(json.dumps({'dp_path': dp}))
        train = dp_train_path(card, tmp / 'train', tmp / 'oake', tmp / 'dp', prompts)
        log(json.dumps({'dp_train': train}))
        (tmp / 'calibration').mkdir()
        calibration = calibration_path(card, pathlib.Path(dp['coco_config']),
                                       pathlib.Path(dp['dump_dir']), tmp / 'calibration')
    log(json.dumps({'calibration': calibration}))

    log(f'card: {card}')
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
