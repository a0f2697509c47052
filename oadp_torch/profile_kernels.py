"""Time the port's CUDA kernels and its encoder dispatches on the GPU.

    python -m oadp_torch.profile_kernels [--only gemm,attention,...]

Prints JSON lines, each with the card's name and power limit (``--only``
keeps the named parts, default all). Every time comes from
:func:`measure`: a warm-up call, then ``iters`` calls under
``torch.profiler`` with CUDA events around them; it raises when the
session traced no kernel, or traced a kernel family other than the launch
counters say (:data:`FAMILY_COUNTERS`). A ``kernel`` line (:func:`_row`) is
one row of PERF.md §6: a kernel at one shape, its device ms (the traced
kernels' durations a call) and events ms (host launch gaps included), its
plain version's events ms, the library call's (one PyTorch route to the
same function) device and events ms, its bound (operations over 989
TFLOP/s, or 67 fp32 TFLOP/s where it says so, or bytes over 3.35 TB/s,
whichever is larger), the ``ln_gemm`` plan of each of its launches, and
for a layer its device ms by part. The parts:

* ``gemm``: ``ln_gemm`` without LayerNorm under every plan of
  ``ops/attention.py``'s ``GEMM_RATES`` (cooperative at each tile width,
  ping-pong) beside the plan ``ln_gemm_plan`` picks, at each product the
  encoders run: kernel 1's QKV (2048 x 197 rows, 768 -> 2304) and
  out-projection with its residual (768 -> 768), kernel 2's fc with
  quick_gelu (2048 rows, 768 -> 3072) and proj with the residual (3072 ->
  768), the x-stream MLP's two at the objects (2048 x 197), blocks (728 x
  50) and globals (16 x 50) rows, the stock out-projection at the blocks
  and globals rows, and the patch product (3072 -> 768, no epilogue) at
  the objects (2048 x 196), blocks (728 x 49) and globals (16 x 49) rows;
  each with the library route for the same function (``torch.addmm``,
  then quick_gelu or the residual add) and ``torch.mm`` alone, TFLOP/s
  and share of the bound (``gemm`` lines, and ``gemm_residual`` for the
  residual epilogue). Then the rows of kernel 2 (``fused_ln_mlp_rows``,
  2048 rows), ``ln_mlp_residual`` (by part: LN pass, fc with quick_gelu,
  proj with the residual) at the objects, blocks and globals rows and
  ``out_proj_residual`` at the blocks and globals rows (rows 2, 7-8);
* ``attention``: kernel 1 (``fused_surgery_layer``) at the objects
  dispatch (2048 crops x 197 tokens x 12 heads), fold_out and side only,
  by part (LN pass, QKV product, attention, out-projection); kernels 4
  and 5 at the split wiring's 999 crops and at 2048; both attention
  kernels at 2048 x 197 (``long_attention`` routed there for the row);
  ``long_attention`` at an L/14 dispatch (2048 x 1,025 x 16 heads), main
  and side row, the side row alone, and one whole L/14 surgery layer by
  part (rows 1, 1', 4-5', 12-12''); the library route is
  ``F.layer_norm``, ``F.linear`` and SDPA, for ``long_attention`` SDPA on
  contiguous per-head copies;
* ``ln_qkv``: kernel 3 (``fused_ln_qkv_attention``) at the globals (16)
  and blocks (728) batches of 50 tokens, by part, beside the two
  families' route (the LN pass, ``ln_gemm``, ``attention``) (rows 3, 3');
* ``resize``: ``resize_crops`` (``csrc/preprocess.cu``) at an objects
  dispatch's crops (2 x 1024, at their tap bucket 21 and at the CLI's
  largest, 35) and a globals dispatch (16 paired images, 13 taps): beside
  the dense route it replaced (the library), its bound (the fp32 tap
  products these crops need over 67 TFLOP/s, or bytes) and the kernel's
  clock cycles by part (each block's thread 0: the prologue, staging, the
  horizontal and the vertical pass) (rows 9, 9');
* ``patch_embed``: ``patch_rows``, the patch product on ``ln_gemm`` (the
  library ``F.linear``), ``embed_ln_pre`` and the three together (the
  plain route the block product and ``ln_pre``, the library
  ``F.conv2d``) at the surgery encoder's 2048 crops (stride 16) and the
  stock encoder's 16 (stride 32) (rows 10, 10p, 11, 10-11; ``patch_rows``'
  library is the ``unfold`` part);
* ``dispatch``: one objects dispatch (2 images x 1024 crops, tap bucket
  21, full ViT-B/32, bf16, random weights from seed 0): its wall time and
  peak device memory, the CUDA time by kernel and by part (the port's
  kernels by family and ``ln_gemm`` epilogue, the patch product apart;
  cuBLAS products, PyTorch's LayerNorm and elementwise kernels), and the
  entry points' launches;
* ``split_dispatch`` and ``fused_dispatch``: ``objects_step`` on 999
  crops of one image (the surgery encoder's split wiring, kernels 4 and
  5) and on the first 1000 of the same crops (the fused wiring, kernels 1
  and 2), each broken down the same way;
* ``globals_dispatch`` and ``blocks_dispatch``: the stock encoder's
  dispatches (kernel 3), one ``globals_step`` of 16 640x480 images and
  one ``blocks_step`` of 24 (``configs/oake/blocks.py``'s batch): 24
  wholes and their 624 blocks padded to 704, broken down the same way;
* ``text``: one batch of the ViLD prompt builder (256 rows of 77
  tokens) through the full CLIP text tower (width 512, 12 layers, 8
  heads, fp32 products without TF32, random weights from seed 0), broken
  down the same way, beside its operation count and the time it takes
  at the card's fp32 peak outside the tensor cores;
* ``nms``: ``greedy_nms`` (``csrc/nms.cu``) at the main path's shapes,
  as the callers batch it: the RPN's train problem (8,819 candidates at
  the train canvas, IoU 0.7, 1000 kept) at B = 1 and 2, OV-COCO's
  ``multiclass_nms`` (65 classes x 1000, IoU 0.5, 300 kept) at B = 1 and
  32, OV-LVIS's (1203 x 1000, boxes shared or per class) at B = 1 and 2:
  under every plan the kernel is built for (``ops/nms.py:NMS_PLANS``),
  its device ms and its clock cycles by part (a problem's mean: tests
  against the kept list, column words, the barriers, the decisions),
  keep sets held to the plain version's; and the plan ``nms_plan`` picks
  with its events ms, the plain version's and the bound (bytes, or 14
  fp32 operations an IoU pair the inputs need) (rows 6-6'');
* ``unfold``: ``F.unfold``, ``patch_rows``' library call (the conv's
  im2col, transposed to the same rows), at the stock encoder's 16 crops
  (stride 32) and the surgery encoder's 2048 (patch 32, stride 16).

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

PEAK_FLOPS, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12  # H100 SXM: dense bf16, fp32, HBM3


def _kernel_part(name: str) -> str:
    """The part a CUDA kernel of an encoder dispatch belongs to, by its
    (mangled or demangled) name: the port's kernels (namespace ``oadp``)
    by family (the preprocessing's ``resize_crops_kernel``, the patch
    embedding's ``patch_rows_kernel`` and ``embed_ln_pre_kernel`` each a
    part), ``ln_gemm``'s two schedules (``gemm_kernel``,
    ``pingpong_kernel``) by epilogue (their template argument 1: 0, 1 or
    2; the patch embedding's product, epilogue 0, is told apart by its
    place after ``patch_rows`` in :func:`_breakdown`); then PyTorch's
    library products (cuBLAS's ``nvjet``, CUTLASS and xmma kernels),
    LayerNorm and elementwise kernels."""
    if 'oadp' in name:
        gemm = re.search(r'(?:gemm|pingpong)_kernel(?:<\d+, (\d)|ILi\d+ELi(\d)E)', name)
        if gemm:
            return {'1': 'ln_gemm_gelu', '2': 'ln_gemm_residual'}.get(
                gemm.group(1) or gemm.group(2), 'ln_gemm')
        for kernel in ('resize_crops_kernel', 'patch_rows_kernel', 'embed_ln_pre_kernel',
                       'ln_qkv_attention_kernel', 'attention_kernel', 'layer_norm_kernel',
                       'greedy_nms_kernel'):
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


#: family of :func:`_kernel_part` -> the launch counters of ``oadp_torch/ops``
#: (``ROUTES`` of ``attention.py``, ``LAUNCHES`` of ``embed.py``, ``nms.py``
#: and ``preprocess.py``) each of whose launches runs one kernel of it, as
#: ``benchmark/trace.py:check_launches`` holds a session to them; and
#: ``ln_gemm``'s products by epilogue, counted by :func:`measure` itself
FAMILY_COUNTERS = {
    'ln_gemm': ('ln_gemm',),
    'ln_gemm_gelu': ('ln_gemm_gelu',),
    'ln_gemm_residual': ('ln_gemm_residual',),
    'attention_kernel': ('attention', 'long_attention'),
    'resize_crops_kernel': ('resize_crops',),
    'patch_rows_kernel': ('patch_rows',),
    'embed_ln_pre_kernel': ('embed_ln_pre',),
    'greedy_nms_kernel': ('greedy_nms',),
}

#: the parts of a layer's device time, by :func:`_kernel_part`: kernels 1
#: and 3 (the LN pass, kernel 3's fused QKV product and attention, the QKV
#: product, attention, the out-projection: ``ln_gemm`` with the residual
#: epilogue), and ``ln_mlp_residual`` (the LN pass, fc with the quick_gelu
#: epilogue, proj with the residual epilogue)
LAYER_PARTS = {'ln_qkv_attention_kernel': 'qkv_attention', 'layer_norm_kernel': 'ln',
               'attention_kernel': 'attention', 'ln_gemm': 'qkv',
               'ln_gemm_residual': 'out_projection'}
MLP_PARTS = {'layer_norm_kernel': 'ln', 'ln_gemm_gelu': 'fc_gelu',
             'ln_gemm_residual': 'proj_residual'}


def _counters() -> dict:
    from .ops import attention, embed, nms, preprocess

    return {**attention.LAUNCHES, **attention.ROUTES, **embed.LAUNCHES, **nms.LAUNCHES,
            **preprocess.LAUNCHES}


def _kernel_ms(e) -> float:
    return (e.time_range.end - e.time_range.start) / 1e3


#: profiler sessions :func:`measure` runs before it raises
SESSIONS = 3


def measure(fn, iters: int, profiled: bool = True) -> dict:
    """``fn`` on the card: a warm-up call, then ``iters`` calls under
    ``torch.profiler`` with CUDA events around the same calls. Returns a
    call's ``events_ms`` (host launch gaps included) and ``device_ms``
    (the traced kernels' durations), the latter ``by_part``
    (:func:`_kernel_part`), the traced ``kernels`` (profiler events, in
    order on the card), the ``launches`` the calls counted and the
    ``ln_gemm`` ``plans`` (schedule, tile width) of a call. A session
    that traced no kernel, or a family's kernels other than the launches
    of its counters (:data:`FAMILY_COUNTERS`; ``ln_gemm``'s products are
    counted here, a call of ``ops/attention.py:_ln_gemm`` a product of its
    epilogue), dropped kernels and would read low: it is run again, and
    the last of :data:`SESSIONS` raises. With ``profiled=False`` the CUDA
    events alone (``events_ms``), for calls whose device time nothing
    reads: a plain version's thousands of launches would only slow the
    session."""
    fn()
    torch.cuda.synchronize()
    if not profiled:
        return dict(events_ms=_events_ms(fn, iters))
    for session in range(1, SESSIONS + 1):
        try:
            return _session(fn, iters)
        except _Dropped as e:
            if session == SESSIONS:
                raise RuntimeError(f'profile: {e} in each of {SESSIONS} sessions') from None
            print(f'profile: session {session} of {SESSIONS}: {e}', file=sys.stderr, flush=True)


class _Dropped(Exception):
    """A profiler session that traced fewer kernels than were launched."""


def _events_ms(fn, iters: int) -> float:
    """Milliseconds a call of ``fn`` by CUDA events around ``iters`` calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _session(fn, iters: int) -> dict:
    """One profiler session of :func:`measure`."""
    from torch.profiler import ProfilerActivity, profile

    from .ops import attention as A

    before = _counters()
    launch, products, plans = A._ln_gemm, {}, []

    def counted(*args, **kwargs):
        part = ('ln_gemm', 'ln_gemm_gelu', 'ln_gemm_residual')[
            kwargs.get('epilogue', args[5] if len(args) > 5 else A._EPI_NONE)]
        products[part] = products.get(part, 0) + 1
        plans.append(launch(*args, **kwargs))
        return plans[-1]

    A._ln_gemm = counted
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # a session may not trace its first launch (the H100's sessions
            # lost one of 50 ``resize_crops`` launches, the first, each
            # time): a spin kernel takes that place and is left out
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            events_ms = _events_ms(fn, iters)
    finally:
        A._ln_gemm = launch
    launches = {k: v - before[k] for k, v in _counters().items() if v != before[k]}
    launches.update(products)
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and 'spin_kernel' not in e.name), key=lambda e: e.time_range.start)
    if not kernels:
        raise _Dropped('the session traced no kernel')
    by_part = {}
    for e in kernels:
        part = _kernel_part(e.name)
        by_part[part] = by_part.get(part, 0.0) + _kernel_ms(e) / iters
    for family, counters in FAMILY_COUNTERS.items():
        traced = sum(_kernel_part(e.name) == family for e in kernels)
        launched = sum(launches.get(c, 0) for c in counters)
        if traced != launched:
            raise _Dropped(f'{traced} {family} kernels traced, {launched} launched')
    return dict(events_ms=events_ms, device_ms=sum(by_part.values()), by_part=by_part,
                kernels=kernels, launches=launches,
                plans=[p._asdict() for p in plans[:len(plans) // iters]])


def _bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> tuple[float, str]:
    """The least ms these operations and bytes take on the card, and which
    of the two bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def _row(emit, name: str, kernel, iters: int, flops: float, nbytes: float, plain=None,
         library=None, peak: float = PEAK_FLOPS, parts=None, **fields) -> None:
    """One kernel's row of PERF.md §6, printed as a ``kernel`` line: its
    device and events ms (:func:`measure`), its plain version's events ms
    and the library call's device and events ms (where given), its bound
    and share of it, its launches and ``ln_gemm`` plans, and with
    ``parts`` (a part of :func:`_kernel_part` -> a name of it) its device
    ms by part."""
    k = measure(kernel, iters)
    bound, by = _bound(flops, nbytes, peak)
    row = dict(name=name, device_ms=k['device_ms'], events_ms=k['events_ms'], bound_ms=bound,
               bound_by=by, bound_share=bound / k['device_ms'], launches=k['launches'],
               plans=k['plans'])
    if parts is not None:
        by_part = row['device_ms_by_part'] = {}
        for part, ms in k['by_part'].items():
            by_part[parts.get(part, 'other')] = by_part.get(parts.get(part, 'other'), 0.0) + ms
    if plain is not None:
        row['plain_ms'] = measure(plain, max(2, iters // 4), profiled=False)['events_ms']
    if library is not None:
        lib = measure(library, iters)
        row.update(library_device_ms=lib['device_ms'], library_events_ms=lib['events_ms'])
    row.update(fields)
    emit('kernel', **row)
    torch.cuda.empty_cache()


def _patch_product(events) -> list:
    """The patch embedding's products among a profile's kernel events,
    each ``(name, ms)``: the first ``ln_gemm`` kernel on the card after
    each ``patch_rows_kernel`` (``ops/embed.py:patch_embed_ln_pre``
    launches the rows, then their product, on one stream)."""
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    found, after_rows = [], False
    for e in kernels:
        part = _kernel_part(e.name)
        if part == 'patch_rows_kernel':
            after_rows = True
        elif part == 'ln_gemm' and after_rows:
            found.append((e.name, _kernel_ms(e)))
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
    (:func:`measure`) the CUDA time by kernel and by part
    (:func:`_kernel_part`, the patch product apart) and the entry points'
    launches."""
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
    m = measure(step, 1)
    parts, top = {}, {}
    for e in m['kernels']:
        for key, table in ((_kernel_part(e.name), parts), (e.name[:80], top)):
            entry = table.setdefault(key, dict(ms=0.0, calls=0))
            entry['ms'] += _kernel_ms(e)
            entry['calls'] += 1
    _split_patch_product(parts, _patch_product(m['kernels']), m['launches'].get('patch_embed', 0))
    return dict(wall_ms=wall_ms, peak_memory_gb=peak_gb, cuda_ms=m['device_ms'], by_part=parts,
                launches=m['launches'],
                top=[dict(name=k, **v) for k, v in sorted(top.items(),
                                                          key=lambda kv: -kv[1]['ms'])[:20]])


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


def _tap_work(taps, ph: int, pw: int) -> float:
    """The fp32 operations a resize's inputs need: a multiply and an add a
    nonzero tap that reads the image, over the horizontal pass's needed
    source rows (those the vertical taps reach inside the image) and the
    vertical pass's outputs, three channels each, and the normalisation's
    subtract and divide."""
    wx_w, wx_s, wy_w, wy_s = (t.cpu().numpy() for t in taps)
    k = wx_w.shape[-1]
    cols = wx_s[..., None] + np.arange(k)
    x_taps = ((wx_w != 0) & (cols >= 0) & (cols < pw)).sum((1, 2))  # (crops,)
    rows = wy_s[..., None] + np.arange(k)
    y_live = (wy_w != 0) & (rows >= 0) & (rows < ph)
    work = 0.0
    for c in range(len(wx_w)):
        needed = np.unique(rows[c][y_live[c]]).size
        work += 2 * 3 * (needed * x_taps[c] + y_live[c].sum() * wx_w.shape[1])
    return work + 2 * 3 * len(wx_w) * wx_w.shape[1] * wy_w.shape[1]


def _resize_part(dev, emit) -> None:
    """``resize_crops`` at an objects dispatch's crops (``_dispatch_inputs``'
    proposals, expanded as the CLI expands them) at their tap bucket (21)
    and at the CLI's largest (35), and at a globals dispatch (16 paired
    640 x 480 images, 13 taps)."""
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
        _, taps = P.resize_crops(im, m, k, return_taps=True)
        cycles = torch.zeros(len(m) * P.resize_bands(len(m), 224, sms)[0], 4,
                             dtype=torch.int64, device=dev)
        P.resize_crops(im, m, k, cycles=cycles)
        parts = cycles.sum(0).tolist()
        _row(emit, f'resize_crops({name}: {len(m)} crops, k_pad {k})',
             lambda: P.resize_crops(im, m, k), 10 if len(m) > 16 else 50,
             _tap_work(taps, im.shape[1], im.shape[2]),
             im.numel() + m.numel() * 4 + len(m) * 224 * 224 * 3 * 2,
             plain=lambda: P.resize_crops_plain(im, m, k), library=lambda: _dense_crops(im, m, k),
             peak=PEAK_FP32,
             cycles_share={part: c / sum(parts) for part, c in zip(
                 ('prologue', 'staging', 'horizontal', 'vertical'), parts)},
             cycles_per_block=sum(parts) / len(cycles))


def _unfold_part(dev, gen, emit) -> None:
    """``F.unfold`` as ``patch_rows``' library call: the stock encoder's 16
    crops at stride 32 and the surgery encoder's 2048 at stride 16 (patch
    32, 224-pixel crops, bf16), and whether it gives ``patch_rows``' rows."""
    from .ops import embed as EM

    for crops, stride in ((16, 32), (2048, 16)):
        x = torch.randn(crops, 224, 224, 3, device=dev, generator=gen).bfloat16()
        pad, _ = EM.patch_geometry(224, 32, stride)

        def unfold():
            cols = F.unfold(x.permute(0, 3, 1, 2), 32, padding=pad, stride=stride)
            return cols.transpose(1, 2).reshape(-1, 3 * 32 * 32)

        m = measure(unfold, 3 if crops > 16 else 20)
        emit('unfold', crops=crops, stride=stride, device_ms=m['device_ms'],
             events_ms=m['events_ms'], identical=bool(torch.equal(unfold(),
                                                                 EM.patch_rows(x, 32, stride))))
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
    call, TFLOP/s and share of the bound."""
    x = torch.randn(rows, k_in, device=dev, generator=gen).bfloat16()
    w = (torch.randn(k_in, n_out, device=dev, generator=gen) * k_in ** -0.5).bfloat16()
    wt, wb = A.kmajor(w), (0.02 * torch.randn(n_out, device=dev, generator=gen)).bfloat16()
    out = torch.empty(rows, n_out, device=dev).bfloat16()
    res = (torch.randn(rows, n_out, device=dev, generator=gen).bfloat16()
           if epilogue == A._EPI_RESIDUAL else None)
    iters = max(5, min(200, int(2e11 / (rows * k_in * n_out))))
    flops = 2 * rows * k_in * n_out
    bound, by = _bound(flops, 2 * (rows * k_in + k_in * n_out + n_out
                                   + rows * n_out * (1 + (res is not None))))

    def library():
        h = torch.addmm(wb, x, w)
        if epilogue == A._EPI_GELU:
            return h * torch.sigmoid(1.702 * h)
        return h.add_(res) if res is not None else h

    def kernel(plan=None):
        return lambda: A._ln_gemm(x, wt, wb, out, epilogue=epilogue, residual=res, plan=plan)

    ms = {_plan_name(p): measure(kernel(p), iters)['device_ms'] for p in A.GEMM_RATES}
    pick = A.ln_gemm_plan([(rows, n_out)], k_in, epilogue,
                          torch.cuda.get_device_properties(dev).multi_processor_count)
    ms['library'] = measure(library, iters)['device_ms']
    ms['torch_mm'] = measure(lambda: torch.mm(x, w), iters)['device_ms']
    kind = 'gemm_residual' if res is not None else 'gemm'
    return kind, dict(
        shape=[rows, k_in, n_out], epilogue=epilogue, plan=_plan_name(pick),
        plan_device_ms=ms[_plan_name(pick)], plan_events_ms=measure(kernel(), iters)['events_ms'],
        device_ms=ms, bound_ms=bound, bound_by=by,
        tflops={k: flops / v / 1e9 for k, v in ms.items()},
        bound_share={k: bound / v for k, v in ms.items()})


def _gemm_part(A, gen, dev, emit) -> None:
    """``ln_gemm`` at each encoder product under every plan, then the rows
    of kernel 2, ``ln_mlp_residual`` and ``out_proj_residual``."""
    b, n, d = 2048, 197, 768
    m = b * n
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

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).bfloat16()

    ln_s, ln_b = 1 + r(d, scale=0.1), r(d, scale=0.1)
    fc_w, fc_b = r(d, 4 * d, scale=d ** -0.5), r(4 * d, scale=0.02)
    proj_w, proj_b = r(4 * d, d, scale=(4 * d) ** -0.5), r(d, scale=0.02)
    out_w, out_b = r(d, d, scale=d ** -0.5), r(d, scale=0.02)
    prep = dict(fc_wt=A.kmajor(fc_w), proj_wt=A.kmajor(proj_w), ln32=A.ln_fp32(ln_s, ln_b))
    out_wt = A.kmajor(out_w)
    w_bytes = 2 * (fc_w.numel() + fc_b.numel() + proj_w.numel() + proj_b.numel()) + 8 * d

    def library(x):  # the route before ln_gemm took it: F.layer_norm, cuBLAS, quick_gelu, add
        h = F.linear(F.layer_norm(x, (d,), ln_s, ln_b), prep['fc_wt'], fc_b)
        return x + F.linear(h * torch.sigmoid(1.702 * h), prep['proj_wt'], proj_b)

    y = r(b, d)
    mlp = (y, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b)
    _row(emit, f'fused_ln_mlp_rows(B={b})', lambda: A.fused_ln_mlp_rows(*mlp, **prep), 50,
         4 * b * d * 4 * d, 2 * (2 * y.numel() + fc_w.numel() + proj_w.numel() + 6 * d),
         plain=lambda: A.fused_ln_mlp_rows_plain(*mlp), library=lambda: library(y))
    for rows, tokens, iters in ((b, n, 5), (728, 50, 20), (16, 50, 50)):
        m = rows * tokens
        x, a = r(rows, tokens, d), r(rows, tokens, d)
        args = (x, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b)
        _row(emit, f'ln_mlp_residual(M={m})', lambda: A.ln_mlp_residual(*args, **prep), iters,
             4 * m * d * 4 * d, 2 * 2 * x.numel() + w_bytes,  # x read, out written, the weights
             plain=lambda: A.ln_mlp_residual_plain(*args), library=lambda: library(x),
             parts=MLP_PARTS)
        if rows != b:  # no objects layer takes out_proj_residual
            _row(emit, f'out_proj_residual(M={m})',
                 lambda: A.out_proj_residual(x, a, out_w, out_b, out_wt=out_wt), iters,
                 2 * m * d * d, 2 * (3 * x.numel() + d * d + d),  # x and a read, out written
                 plain=lambda: A.out_proj_residual_plain(x, a, out_w, out_b),
                 library=lambda: x + F.linear(a, out_wt, out_b))
        del x, a, args


def _heads(t, heads: int):
    """``(B, N, heads x 64)`` -> ``(B, heads, N, 64)``."""
    b, n, _ = t.shape
    return t.reshape(b, n, heads, 64).transpose(1, 2)


def _merge(t):
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def _surgery_inputs(gen, dev, b: int, n: int, heads: int):
    """Random bf16 inputs of one surgery layer (x, y, bias, LN, QKV), with
    -100 on a random half of the patches, and its out-projection."""
    d = heads * 64

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).bfloat16()

    mask = torch.rand(b, n - 1, device=dev, generator=gen) > 0.5
    bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
    return ((r(b, n, d), r(b, d), bias, 1 + r(d, scale=0.1), r(d, scale=0.1),
             r(d, 3 * d, scale=d ** -0.5), r(3 * d, scale=0.02)),
            dict(out_w=r(d, d, scale=d ** -0.5), out_b=r(d, scale=0.02)))


def _layer_flops(b: int, n: int, heads: int, fold_out: bool = True) -> float:
    """A surgery layer's products: QKV of N + 1 rows, the main rows'
    attention, the side row's, and the out-projection of N + 1 rows."""
    d = heads * 64
    return (2 * b * (n + 1) * d * 3 * d + 4 * b * heads * n * n * 64 + 4 * b * heads * n * 64
            + fold_out * 2 * b * (n + 1) * d * d)


def _attention_rows(A, gen, dev, emit, b: int, n: int, heads: int, side_only: bool) -> None:
    """The attention family's one launch (main rows and side row) at
    ``b`` crops of ``n`` tokens, beside SDPA on contiguous per-head copies
    made beforehand; with ``side_only`` the side row alone too."""
    d = heads * 64
    qkv = (torch.randn(b, n, 3 * d, device=dev, generator=gen) * 2).bfloat16()
    qkv_y = (torch.randn(b, 3 * d, device=dev, generator=gen) * 2).bfloat16()
    mask = torch.rand(b, n - 1, device=dev, generator=gen) > 0.5
    bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
    (q, k, v), (qy, ky, vy) = qkv.split(d, -1), qkv_y.split(d, -1)
    main = torch.empty((b, n, d), dtype=torch.bfloat16, device=dev)
    side = torch.empty((b, d), dtype=torch.bfloat16, device=dev)
    q4, k4, v4 = (_heads(t, heads).contiguous() for t in (q, k, v))
    kk, vv = (torch.cat([t[:, :, 1:], ty.reshape(b, heads, 1, 64)], 2)
              for t, ty in ((k4, ky), (v4, vy)))
    qy4, lib_mask = qy.reshape(b, heads, 1, 64), bias[:, None, None, :].bfloat16()

    def library():
        F.scaled_dot_product_attention(q4, k4, v4)
        F.scaled_dot_product_attention(qy4, kk, vv, attn_mask=lib_mask)

    route = 'attention' if n <= A._MAX_TOKENS else 'long_attention'
    _row(emit, f'{route}(B={b}, N={n}, heads={heads})',
         lambda: A._attention(q, k, v, heads, 0.125, out=main, qy=qy, ky=ky, vy=vy, bias=bias,
                              side=side), 3 if n > 256 else 5,
         4 * b * heads * n * n * 64 + 4 * b * heads * n * 64,
         2 * (4 * b * n * d + 4 * b * d) + 4 * b * n, library=library)
    if side_only:  # the last layer: K and V streamed once an item
        _row(emit, f'{route}(B={b}, N={n}, heads={heads}, side row alone)',
             lambda: A._attention(None, k, v, heads, 0.125, qy=qy, ky=ky, vy=vy, bias=bias,
                                  side=side), 5,
             4 * b * heads * n * 64, 2 * (2 * b * n * d + 4 * b * d) + 4 * b * n)


def _attention_part(A, gen, dev, emit) -> None:
    """Kernels 1, 4 and 5, and both attention kernels."""
    b, n, d, heads = 2048, 197, 768, 12
    args, fold = _surgery_inputs(gen, dev, b, n, heads)
    x, y, bias, ln_s, ln_b, qkv_w, qkv_b = args
    args += (heads, 0.125)
    prep = dict(qkv_wt=A.kmajor(qkv_w), ln32=A.ln_fp32(ln_s, ln_b))
    out_wt = A.kmajor(fold['out_w'])
    lib_mask = bias[:, None, None, :].bfloat16()

    def library(with_main):  # F.layer_norm, F.linear, SDPA
        hx, hy = F.layer_norm(x, (d,), ln_s, ln_b), F.layer_norm(y, (d,), ln_s, ln_b)
        q, k, v = (_heads(t, heads) for t in F.linear(hx, prep['qkv_wt'], qkv_b).split(d, -1))
        qy, ky, vy = (t.reshape(b, heads, 1, 64)
                      for t in F.linear(hy, prep['qkv_wt'], qkv_b).split(d, -1))
        side = F.scaled_dot_product_attention(
            qy, torch.cat([k[:, :, 1:], ky], 2), torch.cat([v[:, :, 1:], vy], 2),
            attn_mask=lib_mask).reshape(b, 1, d)
        if not with_main:
            return side
        main = _merge(F.scaled_dot_product_attention(q, k, v))
        proj = F.linear(torch.cat([main, side], 1), out_wt, fold['out_b'])
        return proj + torch.cat([x, y[:, None]], 1)

    w_bytes = 2 * (qkv_w.numel() + qkv_b.numel() + 2 * d)
    act_bytes = 2 * (x.numel() + y.numel()) + 4 * bias.numel()
    _row(emit, f'fused_surgery_layer(B={b}, N={n}, fold_out)',
         lambda: A.fused_surgery_layer(*args, **fold, **prep, out_wt=out_wt), 5,
         _layer_flops(b, n, heads), 2 * act_bytes - 4 * bias.numel() + w_bytes + 2 * (d * d + d),
         plain=lambda: A.fused_surgery_layer_plain(*args, **fold),
         library=lambda: library(True), parts=LAYER_PARTS)
    _row(emit, f'fused_surgery_layer(B={b}, N={n}, with_main=False)',
         lambda: A.fused_surgery_layer(*args, with_main=False, **prep), 5,
         2 * b * n * d * 2 * d + 2 * b * d * 3 * d + 4 * b * heads * n * 64,
         act_bytes + 2 * y.numel() + w_bytes,
         plain=lambda: A.fused_surgery_layer_plain(*args, with_main=False),
         library=lambda: library(False), parts=LAYER_PARTS)
    del args, fold, x, y, bias, lib_mask
    torch.cuda.empty_cache()

    # kernels 4 and 5: the split wiring's attention, on the packed qkv of
    # a layer (K and V column slices, row stride 3D), at the split path's
    # batch and at the objects dispatch's
    for b in (999, 2048):
        qkv, qkv_y = (torch.randn(b, n, 3 * d, device=dev, generator=gen).bfloat16(),
                      torch.randn(b, 3 * d, device=dev, generator=gen).bfloat16())
        mask = torch.rand(b, n - 1, device=dev, generator=gen) > 0.5
        bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
        (q, k, v), (qy, ky, vy) = qkv.split(d, -1), qkv_y.split(d, -1)
        side_args = (k, v, qy, ky, vy, bias, heads)
        lib_mask = bias[:, None, None, :].bfloat16()

        def side_library():
            heads_y = [t.reshape(b, heads, 1, 64) for t in (qy, ky, vy)]
            kk, vv = (torch.cat([_heads(t, heads)[:, :, 1:], ty], 2)
                      for t, ty in ((k, heads_y[1]), (v, heads_y[2])))
            return F.scaled_dot_product_attention(heads_y[0], kk, vv, attn_mask=lib_mask)

        _row(emit, f'fused_mha_qkv(B={b})', lambda: A.fused_mha_qkv(qkv, heads, 0.125), 5,
             4 * b * heads * n * n * 64, 2 * 4 * b * n * d,  # q, k, v read, the output written
             plain=lambda: A.fused_mha_qkv_plain(qkv, heads, 0.125),
             library=lambda: _merge(F.scaled_dot_product_attention(
                 *(_heads(t, heads) for t in (q, k, v)))))
        _row(emit, f'fused_side_attention(B={b})', lambda: A.fused_side_attention(*side_args),
             20, 4 * b * n * d, 2 * (2 * b * (n - 1) * d + 4 * b * d) + 4 * bias.numel(),
             plain=lambda: A.fused_side_attention_plain(*side_args), library=side_library)
        del qkv, qkv_y, bias, q, k, v, qy, ky, vy, side_args, lib_mask
        torch.cuda.empty_cache()

    # both attention kernels at B/32's length (the route lowered for the
    # long one), then long_attention at L/14's, and an L/14 layer by part
    limit = A._MAX_TOKENS
    for lowered in (limit, 0):
        A._MAX_TOKENS = lowered
        try:
            _attention_rows(A, gen, dev, emit, 2048, n, heads, side_only=False)
        finally:
            A._MAX_TOKENS = limit
    _attention_rows(A, gen, dev, emit, 2048, 1025, 16, side_only=True)
    args, fold = _surgery_inputs(gen, dev, 2048, 1025, 16)
    _row(emit, 'fused_surgery_layer(L/14: B=2048, N=1025, fold_out)',
         lambda: A.fused_surgery_layer(*args, 16, 0.125, **fold), 2,
         _layer_flops(2048, 1025, 16), 2 * 2 * args[0].numel() + 2 * 4 * 1024 * 1024,
         parts=LAYER_PARTS)


def _ln_qkv_part(A, gen, dev, emit) -> None:
    """Kernel 3 at the globals (16) and blocks (728) batches of 50 tokens,
    beside the two families' route and the library calls."""
    d, heads, n = 768, 12, 50
    ln_s = (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).bfloat16()
    ln_b = (0.1 * torch.randn(d, device=dev, generator=gen)).bfloat16()
    w = (torch.randn(d, 3 * d, device=dev, generator=gen) * d ** -0.5).bfloat16()
    wb = (0.02 * torch.randn(3 * d, device=dev, generator=gen)).bfloat16()
    wt, ln32 = A.kmajor(w), A.ln_fp32(ln_s, ln_b)
    for b in (16, 728):
        x = torch.randn(b, n, d, device=dev, generator=gen).bfloat16()
        iters = 50 if b == 16 else 10

        def families():
            qkv = torch.empty(b, n, 3 * d, device=dev, dtype=x.dtype)
            A._ln_gemm(x.view(-1, d), wt, wb, qkv.view(-1, 3 * d), ln32=ln32)
            A._attention(*qkv.split(d, -1), heads, 0.125, out=torch.empty_like(x))

        def library():
            h = F.linear(F.layer_norm(x, (d,), ln_s, ln_b), wt, wb)
            return _merge(F.scaled_dot_product_attention(
                *(_heads(t, heads) for t in h.split(d, -1))))

        fam = measure(families, iters)
        _row(emit, f'fused_ln_qkv_attention(B={b}, N={n})',
             lambda: A.fused_ln_qkv_attention(x, ln_s, ln_b, w, wb, heads, 0.125, qkv_wt=wt,
                                              ln32=ln32), iters,
             2 * b * n * d * 3 * d + 4 * b * heads * n * n * 64,
             2 * 2 * x.numel() + 2 * (w.numel() + wb.numel() + 2 * d),
             plain=lambda: A.fused_ln_qkv_attention_plain(x, ln_s, ln_b, w, wb, heads, 0.125),
             library=library, parts=LAYER_PARTS, families_device_ms=fam['device_ms'],
             families_events_ms=fam['events_ms'])
        del x


def _patch_embed_part(model, gen, dev, emit) -> None:
    """``patch_rows``, the patch product, ``embed_ln_pre`` and the whole
    embedding at the surgery encoder's 2048 crops and the stock encoder's
    16, random ViT-B/32 weights from seed 0, bf16."""
    from .models import clip as C
    from .ops import embed as EM

    for b, params, cfg in ((2048, model.surgery_params, model.surgery_config),
                           (16, model.params, model.config)):
        crops = torch.randn(b, 224, 224, 3, device=dev, generator=gen).bfloat16()
        p, s, d, g = cfg.patch_size, cfg.stride, cfg.width, cfg.grid
        kern, ln = params['kernel'], params['ln_pre']
        iters = 10 if b > 16 else 50
        pad, _ = EM.patch_geometry(224, p, s)
        rows = EM.patch_rows(crops, p, s)
        x = EM.patch_embed(rows, kern['conv1_wt'], kern['conv1_b'])
        _row(emit, f'patch_rows({b} crops, stride {s})', lambda: EM.patch_rows(crops, p, s),
             iters, 0.0, crops.numel() * 2 + rows.numel() * 2,
             plain=lambda: EM.patch_rows_plain(crops, p, s))
        _row(emit, f'patch_embed(M={rows.shape[0]}, K={rows.shape[1]}, N={d})',
             lambda: EM.patch_embed(rows, kern['conv1_wt'], kern['conv1_b']), iters,
             2.0 * rows.shape[0] * rows.shape[1] * d,
             rows.numel() * 2 + kern['conv1_wt'].numel() * 2 + x.numel() * 2,
             plain=lambda: EM.patch_embed_plain(rows, kern['conv1_wt']),
             library=lambda: F.linear(rows, kern['conv1_wt']))
        del rows
        x = x.view(b, g * g, d)
        ln_args = (x, params['class_embedding'], params['positional_embedding'], ln['scale'],
                   ln['bias'])
        _row(emit, f'embed_ln_pre({b} x {g * g + 1} x {d})',
             lambda: EM.embed_ln_pre(*ln_args, ln32=kern['ln_pre']), iters,
             0.0, x.numel() * 2 + b * (g * g + 1) * d * 2 + (g * g + 2) * d * 2 + 8 * d,
             plain=lambda: EM.embed_ln_pre_plain(*ln_args),
             library=lambda: EM.embed_ln_pre_plain(*ln_args))
        del x, ln_args

        def conv_route():
            y = F.conv2d(crops.permute(0, 3, 1, 2), params['conv1'], stride=s, padding=pad)
            y = torch.cat([params['class_embedding'].expand(b, 1, d), y.flatten(2).transpose(1, 2)],
                          1) + params['positional_embedding']
            return F.layer_norm(y, (d,), ln['scale'], ln['bias'], 1e-5)

        _row(emit, f'embedding({b} crops: patch_rows + ln_gemm + embed_ln_pre)',
             lambda: C._embed_ln_pre(crops, params, cfg), iters, 2.0 * b * g * g * 3 * p * p * d,
             crops.numel() * 2 + b * (g * g + 1) * d * 2 + params['conv1'].numel() * 2,
             plain=lambda: C._layer_norm(C._embed_patches(crops, params, cfg), params['ln_pre']),
             library=conv_route)
        del crops


def _nms_problems(dev, gen):
    """The ``greedy_keep_sorted`` arguments of each ``nms`` shape:
    ``rpn_proposals`` on random logits and deltas at the train canvas
    (the top 2000 of each level), ``multiclass_nms`` on boxes clustered
    round 40 objects of an 800 x 1199 image with softmax scores."""
    from .models import rpn as RPN
    from .ops import nms as NMS
    from .ops.anchors import AnchorGenerator

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

    def det(images, classes, per_class=False, n=1000):
        centre = torch.rand(images, 40, 2, device=dev, generator=gen) * torch.tensor(
            [1199., 800.], device=dev)
        size = 30 + 270 * torch.rand(images, 40, 2, device=dev, generator=gen)
        k = torch.randint(0, 40, (images, n, 1), device=dev, generator=gen).expand(-1, -1, 2)
        jitter = 1 + 0.15 * torch.randn(images, n, 2, device=dev, generator=gen)
        c, sz = torch.gather(centre, 1, k), torch.gather(size, 1, k) * jitter
        boxes = torch.cat([c - sz / 2, c + sz / 2], -1).clamp(min=0)
        if per_class:
            boxes = (boxes[:, :, None] + 4 * torch.randn(images, n, classes, 4, device=dev,
                                                         generator=gen)
                     ).clamp(min=0).reshape(images, n, classes * 4)
        scores = torch.softmax(2 * torch.randn(images, n, classes + 1, device=dev,
                                               generator=gen), -1)
        return captured(lambda: NMS.multiclass_nms(boxes, scores, 0.0, 0.5, 300, classes))

    return [('rpn_train_b1', rpn(1)), ('rpn_train_b2', rpn(2)), ('ov_coco_b1', det(1, 65)),
            ('ov_coco_b32', det(32, 65)), ('ov_lvis_b1', det(1, 1203)),
            ('ov_lvis_b2', det(2, 1203)), ('ov_lvis_per_class_b1', det(1, 1203, True)),
            ('ov_lvis_per_class_b2', det(2, 1203, True))]


#: greedy_nms: the IoU of a pair and its comparison, in fp32 outside the
#: tensor cores: 2 max, 2 min, 2 subtractions and 2 clamps (the overlap), 1
#: product (inter), 1 addition and 1 subtraction (union), 1 clamp, 1
#: division, 1 comparison
IOU_FLOP = 14


def _needed_pairs(keep, alive, max_keep: int) -> int:
    """The IoU pairs these inputs need: each kept candidate against the
    alive ones after it, up to the scan's end (the max_keep-th kept, else
    the last alive)."""
    n = alive.shape[1]
    pos = torch.arange(n, device=alive.device)
    last_kept = torch.where(keep, pos, -1).amax(1)
    last_alive = torch.where(alive, pos, -1).amax(1)
    end = torch.where(keep.sum(1) >= max_keep, last_kept, last_alive) + 1
    acum = alive.long().cumsum(1)
    total = acum.gather(1, (end - 1).clamp(min=0)[:, None]) * (end > 0)[:, None]
    return int(((total - acum) * keep).sum())


def _nms_part(dev, gen, emit) -> None:
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
                device_ms=measure(lambda: NMS._greedy_nms(*a, **k, plan=plan), 20)['device_ms'],
                cycles_per_problem={q: c / p for q, c in zip(parts, total)})
        if not all(r['identical'] for r in by_plan.values()):
            raise AssertionError(f'greedy_nms {shape}: a plan\'s keep sets differ')
        order = k.get('order')
        _row(emit, f'greedy_nms({shape})', lambda: NMS.greedy_keep_sorted(*a, **k), 20,
             IOU_FLOP * _needed_pairs(want, alive, max_keep),
             boxes.numel() * 4 + (order.numel() * 8 if order is not None else 0) + 2 * p * n,
             plain=lambda: NMS.greedy_keep_sorted_plain(*a, **k), peak=PEAK_FP32,
             problems=p, candidates=n, iou=thr, max_keep=max_keep, kept=int(want.sum()),
             plan=_nms_plan_name(NMS.nms_plan(p, n, sms)),
             fastest=min(by_plan, key=lambda name: by_plan[name]['device_ms']), by_plan=by_plan)


def _nms_plan_name(plan) -> str:
    """``c8t1024x64``: cluster, threads, tile."""
    return f'c{plan.cluster}t{plan.threads}x{plan.tile}'


def _plan_name(plan) -> str:
    """``cooperative256``, ``cooperative64``, ``pingpong256``."""
    return f'{plan.schedule}{plan.tile_n}'


def main(argv=None) -> int:
    import argparse

    parts = ('gemm', 'attention', 'ln_qkv', 'resize', 'patch_embed', 'dispatch',
             'globals_dispatch', 'blocks_dispatch', 'text', 'nms', 'unfold')
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
    if 'gemm' in only:
        _gemm_part(A, gen, dev, emit)
    if 'nms' in only:
        _nms_part(dev, gen, emit)
    if 'resize' in only:
        _resize_part(dev, emit)
    if 'attention' in only:
        _attention_part(A, gen, dev, emit)
    if 'ln_qkv' in only:
        _ln_qkv_part(A, gen, dev, emit)
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
                 fp32_peak_ms=1e3 * flops / PEAK_FP32,
                 **_breakdown(lambda: C.text_encoder(text, tokens, cfg)))
        del text, tokens
    if only & {'patch_embed', 'dispatch', 'globals_dispatch', 'blocks_dispatch'}:
        model = E.load_clip(None, 'bfloat16', device=dev)
        if 'patch_embed' in only:
            _patch_embed_part(model, gen, dev, emit)
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
        del model
        torch.cuda.empty_cache()
    if 'unfold' in only:
        _unfold_part(dev, gen, emit)
    return 0


if __name__ == '__main__':
    sys.exit(main())
