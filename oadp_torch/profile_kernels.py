"""Time the port's CUDA kernels and one objects dispatch on the GPU.

    python -m oadp_torch.profile_kernels [--only gemm,attention,...]

Prints JSON lines, each with the card's name and power limit (``--only``
keeps the named parts, default all):

* ``gemm``: ``ln_gemm`` without LayerNorm under every plan of
  ``ops/attention.py``'s ``GEMM_RATES`` (cooperative at each tile width,
  ping-pong) beside the plan ``ln_gemm_plan`` picks, at each product the encoders run: kernel
  1's QKV (2048 x 197 rows, 768 -> 2304) and out-projection with its
  residual (768 -> 768), kernel 2's fc with quick_gelu (2048 rows, 768 ->
  3072) and proj with the residual (3072 -> 768), the x-stream MLP's two
  at the objects (2048 x 197), blocks (728 x 50) and globals (16 x 50)
  rows, the stock out-projection at the blocks and globals rows, and the
  patch product (3072 -> 768, no epilogue) at the objects (2048 x 196),
  blocks (728 x 49) and globals (16 x 49) rows; each with the library
  route for the same function (``torch.addmm``, then quick_gelu or the
  residual add) and ``torch.mm`` alone, device ms from ``torch.profiler``,
  TFLOP/s and share of the bound (``gemm`` lines, and ``gemm_residual``
  for the residual epilogue);
* ``ln_qkv``: kernel 3 (``fused_ln_qkv_attention``) at the globals (16)
  and blocks (728) batches of 50 tokens, by kernel (device time from
  ``torch.profiler``), beside the two families' route (the LN pass,
  ``ln_gemm``, ``attention``) and the library calls (``F.layer_norm``,
  ``F.linear``, SDPA) on the same inputs;
* ``resize``: ``resize_crops`` (``csrc/preprocess.cu``) at an objects
  dispatch's crops (2 x 1024, at their tap bucket 21 and at the CLI's
  largest, 35) and a globals dispatch (16 paired images, 13 taps): device
  ms beside the dense route it replaced and the bound of its bytes, and
  the kernel's clock cycles by part (each block's thread 0: the prologue,
  staging, the horizontal and the vertical pass);
* ``patch_embed``: the surgery encoder's patch embedding at 2048 crops:
  the kernels' route (``patch_rows``, the product on ``ln_gemm``,
  ``embed_ln_pre``; each apart, and the three with ``ln_pre`` in events and
  device ms) beside the block product of ``models/clip.py`` (alone and
  with ``ln_pre``) and ``F.conv2d``;
* ``unfold``: ``F.unfold``, ``patch_rows``' library call (the conv's
  im2col, transposed to the same rows), at the surgery encoder's 2048
  crops (patch 32, stride 16) and the stock encoder's 16 (stride 32):
  device ms from ``torch.profiler`` in a process of its own (``chip_smoke.py``
  runs it as a child: its per-crop launches left later profiler sessions of
  the same process empty), beside CUDA events;
* ``attention``: the ``attention`` kernel at 2048 crops x 12 heads x 197
  tokens (main rows, side row, both) beside
  ``F.scaled_dot_product_attention`` on the main rows;
* ``dispatch``: one objects dispatch (2 images x 1024 crops, tap bucket
  21, full ViT-B/32, bf16, random weights from seed 0): its wall time and
  peak device memory, the CUDA time by kernel from ``torch.profiler`` and
  by part (the port's kernels by family and ``ln_gemm`` epilogue, the
  patch product apart; cuBLAS products, PyTorch's LayerNorm and
  elementwise kernels), and the entry points' launches;
* ``split_dispatch`` and ``fused_dispatch``: ``objects_step`` on 999
  crops of one image (the surgery encoder's split wiring, kernels 4 and
  5) and on the first 1000 of the same crops (the fused wiring, kernels 1
  and 2), each broken down the same way;
* ``globals_dispatch`` and ``blocks_dispatch``: the stock encoder's
  dispatches (kernel 3), one ``globals_step`` of 16 640x480 images and
  one ``blocks_step`` of 24 (``configs/oake/blocks.py``'s batch): 24
  wholes and their 624 blocks padded to 704, the 728-crop blocks batch of
  ``chip_smoke.py``, broken down the same way;
* ``nms``: ``greedy_nms`` (``csrc/nms.cu``) at the main path's shapes,
  as the callers batch it: the RPN's train problem (8,819 candidates at
  the train canvas, IoU 0.7, 1000 kept) at B = 1 and 2, OV-COCO's
  ``multiclass_nms`` (65 classes x 1000, IoU 0.5, 300 kept) at B = 1 and
  32, OV-LVIS's (1203 x 1000) at B = 2: under every plan the kernel is
  built for (``ops/nms.py:NMS_PLANS``), its device ms from
  ``torch.profiler`` and its clock cycles by part (a problem's mean:
  tests against the kept list, column words, the barriers, the
  decisions), keep sets held to the plain version's, beside the plan
  ``nms_plan`` picks;
* ``text``: one batch of the ViLD prompt builder (256 rows of 77
  tokens) through the full CLIP text tower (width 512, 12 layers, 8
  heads, fp32 products without TF32, random weights from seed 0), broken
  down the same way, beside its operation count and the time it takes
  at the card's fp32 peak outside the tensor cores.

Needs one CUDA device; exits nonzero without one.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F


def _timed(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_part(name: str) -> str:
    """The part a CUDA kernel of an encoder dispatch belongs to, by its
    (mangled or demangled) name: the port's kernels (namespace ``oadp``)
    by family (the preprocessing's ``resize_crops_kernel``, the patch
    embedding's ``patch_rows_kernel`` and ``embed_ln_pre_kernel`` each a
    part), ``ln_gemm``'s two schedules (``gemm_kernel``,
    ``pingpong_kernel``) by epilogue (their template argument 1: 0, 1 or
    2; the patch embedding's product, epilogue 0, is told apart by its
    profiler range in :func:`_breakdown`); then PyTorch's library products
    (cuBLAS's ``nvjet``, CUTLASS and xmma kernels), LayerNorm and
    elementwise kernels."""
    if 'oadp' in name:
        gemm = re.search(r'(?:gemm|pingpong)_kernel(?:<\d+, (\d)|ILi\d+ELi(\d)E)', name)
        if gemm:
            return {'1': 'ln_gemm_gelu', '2': 'ln_gemm_residual'}.get(
                gemm.group(1) or gemm.group(2), 'ln_gemm')
        for kernel in ('resize_crops_kernel', 'patch_rows_kernel', 'embed_ln_pre_kernel',
                       'ln_qkv_attention_kernel', 'attention_kernel', 'layer_norm_kernel'):
            if kernel in name:
                return kernel
        return 'oadp_other'
    low = name.lower()
    if any(k in low for k in ('nvjet', 'gemm', 'cutlass', 'xmma', 'cublas', 'sm90_')):
        return 'cublas_gemm'
    if 'layer_norm' in low:
        return 'torch_layer_norm'
    if 'elementwise' in low:
        return 'torch_elementwise'
    return 'other'


def _patch_product(events) -> list:
    """The patch embedding's products among a profile's events
    (``prof.events()``), each ``(name, ms)``: the first ``ln_gemm`` kernel
    on the card after each ``patch_rows_kernel`` (``ops/embed.py:
    patch_embed_ln_pre`` launches the rows, then their product, on one
    stream)."""
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    found, after_rows = [], False
    for e in kernels:
        part = _kernel_part(e.name)
        if part == 'patch_rows_kernel':
            after_rows = True
        elif part == 'ln_gemm' and after_rows:
            found.append((e.name, (e.time_range.end - e.time_range.start) / 1e3))
            after_rows = False
    return found


def _split_patch_product(parts: dict, patch: list, launches: int) -> None:
    """Move the patch products (:func:`_patch_product`) from the ``ln_gemm``
    part to a part of their own, ``ln_gemm_patch``. Raises when the entry
    counted another number of ``launches``: the split would misname the
    products then."""
    if len(patch) != launches:
        raise RuntimeError(f'profile: {launches} patch products launched, {len(patch)} '
                           f'found after patch_rows')
    for name, ms in patch:
        part = parts[_kernel_part(name)]
        part['ms'] -= ms
        part['calls'] -= 1
        if not part['calls']:
            del parts[_kernel_part(name)]
        moved = parts.setdefault('ln_gemm_patch', dict(ms=0.0, calls=0))
        moved['ms'] += ms
        moved['calls'] += 1


def _breakdown(step) -> dict:
    """Wall time of ``step`` (host clock, synchronised, after two warm
    calls) and its peak device memory over three more, and of one more call
    the CUDA time by kernel and by part (:func:`_kernel_part`, the patch
    product apart) from ``torch.profiler`` and the entry points' launches
    (the ``LAUNCHES`` of ``ops/attention.py``, ``ops/preprocess.py`` and
    ``ops/embed.py``)."""
    from torch.profiler import ProfilerActivity, profile

    from .ops import attention, embed, preprocess

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mods = (attention, preprocess, embed)
    for mod in mods:
        mod.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items() if v}
    # kernels only: an operator's row repeats the time of the kernels it ran
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    parts = {}
    for e in events:
        part = parts.setdefault(_kernel_part(e.key), dict(ms=0.0, calls=0))
        part['ms'] += e.self_device_time_total / 1e3
        part['calls'] += e.count
    _split_patch_product(parts, _patch_product(prof.events()), embed.LAUNCHES['patch_embed'])
    return dict(wall_ms=wall_ms, peak_memory_gb=peak_gb,
                cuda_ms=sum(e.self_device_time_total for e in events) / 1e3,
                by_part=parts, launches=launches,
                top=[dict(name=e.key[:80], ms=e.self_device_time_total / 1e3,
                          calls=e.count) for e in events[:20]])


def _device_ms(fn, iters: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches (``torch.profiler``,
    after a warm-up call), and their sum under ``total``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {e.key[:60]: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA}
    return dict(ms, total=sum(ms.values()))


def _dispatch_inputs(model, pad: int = 640, rows: int = 1024, images: int = 2):
    """Packed buffers as ``ObjectsPipeline.prepare`` builds them."""
    from .ops import boxes as B
    from .ops import preprocess as P

    rng = np.random.RandomState(0)
    bufs = []
    w, h = 640, 480
    for _ in range(images):
        img = np.zeros((pad, pad, 3), np.uint8)
        img[:h, :w] = rng.randint(0, 256, (h, w, 3))
        x0 = rng.uniform(0, w * .8, rows)
        y0 = rng.uniform(0, h * .8, rows)
        props = np.stack([
            x0, y0, np.minimum(x0 + rng.uniform(8, w * .5, rows), w),
            np.minimum(y0 + rng.uniform(8, h * .5, rows), h),
        ], -1).astype(np.float32)
        crops = B.expand_boxes(props, w, h)
        fg = props - np.concatenate([crops[:, :2], crops[:, :2]], -1)
        masks = B.grid_mask(fg, crops, model.grid).astype(np.uint8)
        meta = P.clip_transform_meta(w, h, crops)
        bufs.append(np.concatenate([
            img.reshape(-1), masks.reshape(-1), meta.view(np.uint8).reshape(-1),
        ]))
    return np.stack(bufs)


def _dense_crops(images, meta, k_pad: int):
    """The crops as the route before ``resize_crops`` cut them, one chunk an
    image: ``device_coeffs``, the dense bf16 resize and ``normalize_clip``
    (``oake/encoders.py:OakeSteps._crops`` off the kernel): the library
    yardstick of ``resize_crops``."""
    from .ops import preprocess as P

    per = len(meta) // len(images)
    chunks = [(images, meta)] if per == 1 else [(images[i], meta[i * per:(i + 1) * per])
                                                for i in range(len(images))]
    return torch.cat([P.normalize_clip(P.apply_resize_coeffs(
        img.float(), *P.device_coeffs(m, k_pad), compute_dtype=torch.bfloat16),
        torch.bfloat16) for img, m in chunks])


def _resize_probe(dev, emit) -> None:
    """``resize_crops`` at an objects dispatch's crops (``_dispatch_inputs``'
    proposals, expanded as the CLI expands them) at their tap bucket (21)
    and at the CLI's largest (35), and at a globals dispatch (16 paired
    640 x 480 images, 13 taps): device ms beside the dense route it
    replaced, and the bound of the crops' bytes."""
    from .ops import preprocess as P

    class _Grid:
        grid = 14

    bufs = _dispatch_inputs(_Grid)
    n_img, n_mask = 640 * 640 * 3, 1024 * 14 * 14
    images = torch.from_numpy(bufs[:, :n_img].reshape(2, 640, 640, 3)).to(dev)
    meta = torch.from_numpy(np.ascontiguousarray(bufs[:, n_img + n_mask:]).view(np.float32)
                            .reshape(2048, 9)).to(dev)
    gimg = np.zeros((16, 640, 640, 3), np.uint8)
    gimg[:, :480] = np.random.RandomState(1).randint(0, 256, (16, 480, 640, 3))
    gmeta = np.repeat(P.clip_transform_meta(640, 480, np.asarray([[0.0, 0, 640, 480]])), 16, 0)
    cases = (('dispatch', images, meta, 21), ('dispatch', images, meta, 35),
             ('globals', torch.from_numpy(gimg).to(dev), torch.from_numpy(gmeta).to(dev), 13))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, im, m, k in cases:
        nbytes = im.numel() + m.numel() * 4 + len(m) * 224 * 224 * 3 * 2
        cycles = torch.zeros(len(m) * P.resize_bands(len(m), 224, sms)[0], 4,
                             dtype=torch.int64, device=dev)
        P.resize_crops(im, m, k, cycles=cycles)
        parts = cycles.sum(0).tolist()
        emit('resize', case=name, crops=len(m), k_pad=k,
             device_ms=_device_ms(lambda: P.resize_crops(im, m, k), 10)['total'],
             dense_device_ms=_device_ms(lambda: _dense_crops(im, m, k), 3)['total'],
             bound_ms=1e3 * nbytes / 3.35e12,
             cycles_share={part: c / sum(parts) for part, c in zip(
                 ('prologue', 'staging', 'horizontal', 'vertical'), parts)},
             cycles_per_block=sum(parts) / len(cycles))


def _unfold_probe(dev, gen, emit) -> None:
    """``F.unfold`` as ``patch_rows``' library call: the surgery encoder's
    2048 crops at stride 16 and the stock encoder's 16 at stride 32 (patch
    32, 224-pixel crops, bf16): device ms a call from ``torch.profiler``
    and CUDA-event ms."""
    from .ops import embed as EM

    for crops, stride in ((2048, 16), (16, 32)):
        x = torch.randn(crops, 224, 224, 3, device=dev, generator=gen).bfloat16()
        pad, _ = EM.patch_geometry(224, 32, stride)

        def unfold():
            cols = F.unfold(x.permute(0, 3, 1, 2), 32, padding=pad, stride=stride)
            return cols.transpose(1, 2).reshape(-1, 3 * 32 * 32)

        iters = 3 if crops > 16 else 20
        emit('unfold', crops=crops, stride=stride, device_ms=_device_ms(unfold, iters)['total'],
             events_ms=_timed(unfold, iters))
        del x
        torch.cuda.empty_cache()


def _blocks_inputs(device, images: int = 24, pad: int = 640, w: int = 640, h: int = 480):
    """``blocks_step`` arguments as ``BlocksPipeline`` builds them for
    ``images`` random w x h images (``configs/oake/blocks.py``: blocks of
    224, stride 112, rescale 1.5, at most 6 levels; the resize matrices on
    ``device``, made once as the CLI caches them per image size), the flat
    blocks padded with zero rows to 704, and the count of real blocks."""
    from .oake.partitions import plan_blocks
    from .ops import preprocess as P

    plan = plan_blocks(w, h, 224, 112, 1.5)
    lwx, lwy = (np.zeros((6, pad, pad), np.float32) for _ in range(2))
    for k in range(len(plan.levels) - 1):
        (w0, h0), (w1, h1) = plan.levels[k], plan.levels[k + 1]
        mx, my = P.plain_resize_matrices(w0, h0, w1, h1, pad, pad)
        lwx[k, :w1], lwy[k, :h1] = mx, my
    wwx, wwy = P.clip_transform_matrices(w, h, None, pad, pad)
    lwx, lwy, wwx, wwy = (torch.from_numpy(a).to(device) for a in (lwx, lwy, wwx, wwy))
    rng = np.random.RandomState(0)
    imgs = np.zeros((images, pad, pad, 3), np.uint8)
    imgs[:, :h, :w] = rng.randint(0, 256, (images, h, w, 3))
    coords = np.asarray([(i, lv, y, x) for i in range(images) for lv, x, y in plan.blocks],
                        np.int32)
    if len(coords) > 704:
        raise ValueError(f'{len(coords)} blocks exceed the bucket of 704')
    coords = np.concatenate([coords, np.zeros((704 - len(coords), 4), np.int32)])
    return (imgs, [lwx] * images, [lwy] * images, [wwx] * images, [wwy] * images,
            coords), len(plan.blocks) * images


def _gemm_probe(A, gen, dev, rows: int, k_in: int, n_out: int, epilogue: int):
    """``ln_gemm`` without LayerNorm at one shape and epilogue under every
    plan of ``A.GEMM_RATES``, beside the plan ``A.ln_gemm_plan`` picks and
    the library route for the same function (``torch.addmm``, then
    quick_gelu or the residual add) and ``torch.mm`` alone: device ms a
    call (``torch.profiler``), TFLOP/s and share of the bound (bytes over
    3.35 TB/s or operations over 989 TFLOP/s, whichever is larger)."""
    x = torch.randn(rows, k_in, device=dev, generator=gen).bfloat16()
    w = (torch.randn(k_in, n_out, device=dev, generator=gen) * k_in ** -0.5).bfloat16()
    wt, wb = A.kmajor(w), (0.02 * torch.randn(n_out, device=dev, generator=gen)).bfloat16()
    out = torch.empty(rows, n_out, device=dev).bfloat16()
    res = (torch.randn(rows, n_out, device=dev, generator=gen).bfloat16()
           if epilogue == A._EPI_RESIDUAL else None)
    iters = max(5, min(200, int(2e11 / (rows * k_in * n_out))))
    flops = 2 * rows * k_in * n_out
    nbytes = 2 * (rows * k_in + k_in * n_out + n_out + rows * n_out * (1 + (res is not None)))
    bound = 1e3 * max(flops / 989e12, nbytes / 3.35e12)

    def library():
        h = torch.addmm(wb, x, w)
        if epilogue == A._EPI_GELU:
            return h * torch.sigmoid(1.702 * h)
        return h.add_(res) if res is not None else h

    def kernel(plan=None):
        return lambda: A._ln_gemm(x, wt, wb, out, epilogue=epilogue, residual=res, plan=plan)

    ms = {_plan_name(p): _device_ms(kernel(p), iters)['total'] for p in A.GEMM_RATES}
    pick = A.ln_gemm_plan([(rows, n_out)], k_in, epilogue,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    ms['library'] = _device_ms(library, iters)['total']
    ms['torch_mm'] = _device_ms(lambda: torch.mm(x, w), iters)['total']
    kind = 'gemm_residual' if res is not None else 'gemm'
    return kind, dict(
        shape=[rows, k_in, n_out], epilogue=epilogue, plan=_plan_name(pick),
        plan_device_ms=ms[_plan_name(pick)], plan_events_ms=_timed(kernel(), iters),
        device_ms=ms, bound_ms=bound, bound_by='operations' if flops / 989e12 >= nbytes / 3.35e12
        else 'bytes', tflops={k: flops / v / 1e9 for k, v in ms.items()},
        bound_share={k: bound / v for k, v in ms.items()})


def _nms_problems(dev, gen):
    """The ``greedy_keep_sorted`` arguments of each ``nms`` probe shape:
    ``rpn_proposals`` on random logits and deltas at the train canvas
    (the top 2000 of each level), ``multiclass_nms`` on boxes clustered
    round 40 objects of an 800 x 1199 image with softmax scores."""
    from .ops import nms as NMS
    from .ops.anchors import AnchorGenerator
    from .models import rpn as RPN

    def captured(fn):
        seen = []
        keep_fn = NMS.greedy_keep_sorted
        NMS.greedy_keep_sorted = lambda *a, **k: seen.append((a, k)) or keep_fn(*a, **k)
        try:
            fn()
        finally:
            NMS.greedy_keep_sorted = keep_fn
        return seen[0]

    canvas = (832, 1344)
    sizes = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in (4, 8, 16, 32, 64)]
    anchors = [torch.from_numpy(a).float().to(dev) for a in AnchorGenerator().grid_anchors(sizes)]

    def rpn(images):
        scores = [torch.randn(images, len(a), device=dev, generator=gen) for a in anchors]
        deltas = [0.2 * torch.randn(images, len(a), 4, device=dev, generator=gen)
                  for a in anchors]
        hw = torch.tensor([[800, 1199], [800, 1333]] * images, device=dev)[:images]
        return captured(lambda: RPN.rpn_proposals(scores, deltas, anchors, hw, nms_pre=2000,
                                                  max_per_img=1000, iou_threshold=0.7))

    def det(images, classes, n=1000):
        centre = torch.rand(images, 40, 2, device=dev, generator=gen) * torch.tensor(
            [1199., 800.], device=dev)
        size = 30 + 270 * torch.rand(images, 40, 2, device=dev, generator=gen)
        k = torch.randint(0, 40, (images, n, 1), device=dev, generator=gen).expand(-1, -1, 2)
        jitter = 1 + 0.15 * torch.randn(images, n, 2, device=dev, generator=gen)
        c, sz = torch.gather(centre, 1, k), torch.gather(size, 1, k) * jitter
        boxes = torch.cat([c - sz / 2, c + sz / 2], -1).clamp(min=0)
        scores = torch.softmax(2 * torch.randn(images, n, classes + 1, device=dev,
                                               generator=gen), -1)
        return captured(lambda: NMS.multiclass_nms(boxes, scores, 0.0, 0.5, 300, classes))

    return [('rpn_train_b1', rpn(1)), ('rpn_train_b2', rpn(2)), ('ov_coco_b1', det(1, 65)),
            ('ov_coco_b32', det(32, 65)), ('ov_lvis_b2', det(2, 1203))]


def _nms_probe(dev, gen, emit) -> None:
    from .ops import nms as NMS

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = ('kept_tests', 'iou_words', 'barriers', 'decisions')
    for shape, (a, k) in _nms_problems(dev, gen):
        boxes, alive, thr, max_keep = a
        p, n = alive.shape
        want = NMS.greedy_keep_sorted_plain(*a, **k)
        by_plan = {}
        for plan in NMS.NMS_PLANS:
            got = NMS._greedy_nms(*a, **k, plan=plan)
            cycles = torch.zeros(p, 4, dtype=torch.int64, device=dev)
            NMS._greedy_nms(*a, **k, plan=plan, cycles=cycles)
            total = cycles.sum(0).tolist()
            by_plan[_nms_plan_name(plan)] = dict(
                identical=bool(torch.equal(got, want)),
                device_ms=_device_ms(lambda: NMS._greedy_nms(*a, **k, plan=plan), 20)['total'],
                cycles_per_problem={q: c / p for q, c in zip(parts, total)})
        picked = NMS.nms_plan(p, n, sms)
        emit('nms', shape=shape, problems=p, candidates=n, iou=thr, max_keep=max_keep,
             kept=int(want.sum()), plan=_nms_plan_name(picked),
             fastest=min(by_plan, key=lambda name: by_plan[name]['device_ms']),
             by_plan=by_plan)
        if not all(r['identical'] for r in by_plan.values()):
            raise AssertionError(f'greedy_nms {shape}: a plan\'s keep sets differ')


def _nms_plan_name(plan) -> str:
    """``c8t1024x64``: cluster, threads, tile."""
    return f'c{plan.cluster}t{plan.threads}x{plan.tile}'


def _plan_name(plan) -> str:
    """``cooperative256``, ``cooperative64``, ``pingpong256``."""
    return f'{plan.schedule}{plan.tile_n}'


def main(argv=None) -> int:
    import argparse

    parts = ('gemm', 'attention', 'ln_qkv', 'resize', 'unfold', 'patch_embed', 'dispatch',
             'globals_dispatch', 'blocks_dispatch', 'text', 'nms')
    ap = argparse.ArgumentParser(description='Time the CUDA kernels on the GPU.')
    ap.add_argument('--only', default=','.join(parts),
                    help=f'comma-separated parts of {parts}')
    only = set(ap.parse_args(argv).only.split(','))
    if not only <= set(parts):
        ap.error(f'--only takes parts of {parts}')
    if not torch.cuda.is_available():
        print('profile_kernels: torch sees no CUDA device', flush=True)
        return 1
    from .models import clip as C
    from .oake import encoders as E
    from .ops import attention as A

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    def emit(kind, **fields):
        print(json.dumps({kind: dict(fields, card=card)}), flush=True)

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    b, n, d, heads = 2048, 197, 768, 12
    m = b * n
    if 'gemm' in only:
        # (M, K, N, epilogue, what): kernel 1's QKV and out-projection,
        # kernel 2's two products, the x-stream MLP's two at the objects,
        # blocks and globals rows, and the stock out-projection
        shapes = [(m, d, 3 * d, A._EPI_NONE, 'kernel 1 qkv'),
                  (m, d, d, A._EPI_RESIDUAL, 'kernel 1 out-projection'),
                  (b, d, 4 * d, A._EPI_GELU, 'kernel 2 fc'),
                  (b, 4 * d, d, A._EPI_RESIDUAL, 'kernel 2 proj')]
        for rows in (m, 728 * 50, 16 * 50):
            shapes += [(rows, d, 4 * d, A._EPI_GELU, 'ln_mlp_residual fc'),
                       (rows, 4 * d, d, A._EPI_RESIDUAL, 'ln_mlp_residual proj')]
        shapes += [(rows, d, d, A._EPI_RESIDUAL, 'out_proj_residual') for rows in (728 * 50, 800)]
        shapes += [(rows, 4 * d, d, A._EPI_NONE, 'patch product')
                   for rows in (b * 196, 728 * 49, 16 * 49)]
        for rows, k_in, n_out, epi, what in shapes:
            kind, fields = _gemm_probe(A, gen, dev, rows, k_in, n_out, epi)
            emit(kind, what=what, **fields)

    if 'nms' in only:
        _nms_probe(dev, gen, emit)
    if 'resize' in only:
        _resize_probe(dev, emit)
    if 'unfold' in only:
        _unfold_probe(dev, gen, emit)
    if 'attention' in only:
        qkv = torch.randn(m, 3 * d, device=dev, generator=gen).bfloat16()
        qkv_y = torch.randn(b, 3 * d, device=dev, generator=gen).bfloat16()
        bias = torch.zeros(b, n, device=dev)
        main = torch.empty(b, n, d, device=dev).bfloat16()
        side = torch.empty(b, d, device=dev).bfloat16()
        qq, kk, vv = qkv.view(b, n, 3 * d).split(d, -1)
        side_args = dict(qy=qkv_y[:, :d], ky=qkv_y[:, d:2 * d], vy=qkv_y[:, 2 * d:],
                         bias=bias, side=side)
        q, k, v = (t.reshape(b, n, heads, 64).transpose(1, 2).contiguous()
                   for t in (qq, kk, vv))
        emit('attention', crops=b, heads=heads, tokens=n,
             main_and_side_ms=_timed(lambda: A._attention(
                 qq, kk, vv, heads, 0.125, out=main, **side_args)),
             main_ms=_timed(lambda: A._attention(qq, kk, vv, heads, 0.125, out=main)),
             side_ms=_timed(lambda: A._attention(None, kk, vv, heads, 0.125, **side_args)),
             sdpa_main_ms=_timed(lambda: F.scaled_dot_product_attention(q, k, v)))
        del qkv, qq, kk, vv, q, k, v, main
        torch.cuda.empty_cache()

    if 'ln_qkv' in only:
        ln_s = (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).bfloat16()
        ln_b = (0.1 * torch.randn(d, device=dev, generator=gen)).bfloat16()
        w = (torch.randn(d, 3 * d, device=dev, generator=gen) * d ** -0.5).bfloat16()
        wb = (0.02 * torch.randn(3 * d, device=dev, generator=gen)).bfloat16()
        wt, ln32 = A.kmajor(w), A.ln_fp32(ln_s, ln_b)
        for b3 in (16, 728):
            x = torch.randn(b3, 50, d, device=dev, generator=gen).bfloat16()
            iters = 200 if b3 == 16 else 50

            def families():
                qkv = torch.empty(b3, 50, 3 * d, device=dev, dtype=x.dtype)
                A._ln_gemm(x.view(-1, d), wt, wb, qkv.view(-1, 3 * d), ln32=ln32)
                A._attention(*qkv.split(d, -1), heads, 0.125, out=torch.empty_like(x))

            def library():
                h = F.linear(F.layer_norm(x, (d,), ln_s, ln_b), wt, wb)
                q, k, v = (t.view(b3, 50, heads, 64).transpose(1, 2) for t in h.split(d, -1))
                return F.scaled_dot_product_attention(q, k, v)

            kernel = lambda: A.fused_ln_qkv_attention(  # noqa: E731
                x, ln_s, ln_b, w, wb, heads, 0.125, qkv_wt=wt, ln32=ln32)
            emit('ln_qkv', crops=b3, tokens=50, kernel_ms=_timed(kernel, iters),
                 kernel_device_ms=_device_ms(kernel, iters),
                 families_ms=_timed(families, iters),
                 families_device_ms=_device_ms(families, iters),
                 library_ms=_timed(library, iters), library_device_ms=_device_ms(library, iters))
            del x
    if 'text' in only:
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = C.TextConfig()
        text = C.map_params(C.init_text_params(torch.Generator().manual_seed(0), cfg),
                            lambda t: t.to(dev))
        rows, n, w = 256, cfg.context_length, cfg.width
        tokens = torch.randint(1, cfg.vocab_size - 1, (rows, n), device=dev, generator=gen)
        tokens[:, 20] = cfg.vocab_size - 1  # the EOT id
        # per layer: QKV, out-projection and MLP products (24 w^2 per token)
        # and the two attention products over all n keys
        flops = cfg.layers * (2 * rows * n * 12 * w * w + 4 * rows * n * n * w) \
            + 2 * rows * w * cfg.output_dim
        with torch.inference_mode():
            emit('text', rows=rows, tokens=n, width=w, layers=cfg.layers, flops=flops,
                 fp32_peak_ms=1e3 * flops / 67e12,
                 **_breakdown(lambda: C.text_encoder(text, tokens, cfg)))
        del text, tokens
    if not only & {'patch_embed', 'dispatch', 'globals_dispatch', 'blocks_dispatch'}:
        return 0
    model = E.load_clip(None, 'bfloat16', device=dev)
    if 'patch_embed' in only:
        crops = torch.randn(b, 224, 224, 3, device=dev, generator=gen).bfloat16()
        cfg, params = model.surgery_config, model.surgery_params
        from .ops import embed as EM

        kern, p, s = params['kernel'], cfg.patch_size, cfg.stride
        rows = EM.patch_rows(crops, p, s)
        x = EM.patch_embed(rows, kern['conv1_wt'], kern['conv1_b'])
        ln = params['ln_pre']
        args = (x.view(b, -1, cfg.width), params['class_embedding'],
                params['positional_embedding'], ln['scale'], ln['bias'])
        fields = dict(
            kernels_ms=_timed(lambda: C._embed_ln_pre(crops, params, cfg)),
            kernels_device_ms=_device_ms(lambda: C._embed_ln_pre(crops, params, cfg), 5),
            patch_rows_ms=_timed(lambda: EM.patch_rows(crops, p, s)),
            patch_embed_ms=_timed(lambda: EM.patch_embed(rows, kern['conv1_wt'],
                                                         kern['conv1_b'])),
            embed_ln_pre_ms=_timed(lambda: EM.embed_ln_pre(*args, ln32=kern['ln_pre'])))
        del rows, x, args
        emit('patch_embed', crops=b, stride=cfg.stride, patch=cfg.patch_size, **fields,
             block_product_ms=_timed(lambda: C._embed_patches(crops, params, cfg)),
             block_product_ln_pre_ms=_timed(lambda: C._layer_norm(
                 C._embed_patches(crops, params, cfg), params['ln_pre'])),
             conv2d_ms=_timed(lambda: F.conv2d(
                 crops.permute(0, 3, 1, 2), params['conv1'], stride=cfg.stride,
                 padding=(cfg.patch_size - 1) // 2)))
        del crops
    if 'dispatch' in only:
        steps = E.OakeSteps(model, 640, 640)
        bufs = _dispatch_inputs(model)
        k_pad = 21  # the tap bucket the objects CLI takes for these crops
        emit('dispatch', crops=2048, k_pad=k_pad,
             **_breakdown(lambda: steps.objects_packed_step(bufs, 1024, k_pad)))
        n_img, g = 640 * 640 * 3, model.grid
        image = bufs[0, :n_img].reshape(640, 640, 3)
        masks = bufs[0, n_img:n_img + 1024 * g * g].reshape(1024, g, g)
        meta = bufs[0, n_img + 1024 * g * g:].view(np.float32).reshape(1024, 9)
        for kind, crops in (('split_dispatch', 999), ('fused_dispatch', 1000)):
            emit(kind, crops=crops, **_breakdown(
                lambda: steps.objects_step(image, meta[:crops], masks[:crops], k_pad)))
    if 'globals_dispatch' in only:
        from .oake.base import bucket
        from .ops import preprocess as P

        steps = E.OakeSteps(model, 640, 640)
        imgs = np.zeros((16, 640, 640, 3), np.uint8)
        imgs[:, :480] = np.random.RandomState(0).randint(0, 256, (16, 480, 640, 3))
        meta = P.clip_transform_meta(640, 480, np.asarray([[0.0, 0, 640, 480]]))
        # the resize taps GlobalsPipeline.prepare and execute_batch pick
        scale = max(meta[0, 2] / meta[0, 4], meta[0, 3] / meta[0, 5], 1.0)
        k = bucket(2 * int(np.ceil(2.0 * scale)) + 1, (5, 9, 13, 21))
        meta = np.repeat(meta, 16, 0)
        emit('globals_dispatch', images=16,
             **_breakdown(lambda: steps.globals_step(imgs, meta, k)))
    if 'blocks_dispatch' in only:
        steps = E.OakeSteps(model, 640, 640)
        args, real = _blocks_inputs(dev)
        emit('blocks_dispatch', wholes=24, blocks=704, real_blocks=real,
             **_breakdown(lambda: steps.blocks_step(*args)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
