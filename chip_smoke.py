"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

1. card: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: the CUDA kernels of ``oadp_torch/csrc`` (nvcc, sm_90a), timed;
3. kernels: each ported kernel at the main path's shapes against its plain
   PyTorch version on the card in bf16 (cosine >= 0.999), timed beside
   its plain version, a PyTorch library yardstick and its bound: kernels
   1-2 at the objects dispatch (2048 crops), kernel 3 at the globals and
   a production blocks batch, kernels 4-5 at the split path's 999 crops
   and at 2048, and the two ``ln_gemm`` routes of the fused layers' glue
   (``ln_mlp_residual``, the x-stream MLP ``x + proj(quick_gelu(fc(LN
   x)))``; ``out_proj_residual``, the stock encoder's ``x + a @ W + b``)
   at the rows of the dispatches that take each (``ln_mlp_residual`` at
   the objects 2048 x 197, blocks 728 x 50 and globals 16 x 50 rows,
   ``out_proj_residual`` at the blocks and globals rows), also on their
   residual deltas (``out - x``), with the ``ln_gemm`` plan each launch
   took (schedule and tile width; ``ops/attention.py:ln_gemm_plan``,
   recorded by ``plans_of``). Each kernel gets its K-major weights and fp32 LayerNorm
   parameters prepared once, as the encoders hold them, and the library
   yardstick its transposed weights once. Two times per call for the
   kernel and for the yardstick: CUDA events around back-to-back calls
   (host launch overhead included) and the device time from
   ``torch.profiler`` (the sum of the call's kernel durations; for
   kernel 1 also by part: LN pass, QKV product, attention,
   out-projection; for kernel 3: LN pass, fused QKV product and
   attention; for ``ln_mlp_residual``: LN pass, fc with quick_gelu, proj
   with the residual). Kernels 1 and 3 and ``ln_mlp_residual`` are also
   held to their plain versions on rows with a large per-row mean and
   outlier columns, as CLIP residual streams carry; where the output
   carries the residual (kernel 1, ``ln_mlp_residual``), also to within
   0.125 beyond one bf16 unit in the last place, as the residual swamps
   the delta in a cosine. Then ``greedy_nms`` (``csrc/nms.cu``) against its plain
   version on the card, identical keep sets required, as the callers
   batch it (one launch a call): the RPN's one ``batched_nms`` call over
   a train step's two images at the train canvas (8,819 candidates an
   image, IoU 0.7, 1000 kept; clusters of blocks) and each image alone,
   ``multiclass_nms`` at OV-COCO (65 x 1000, IoU 0.5, 300 a class) on one
   image and on a 32-image ``rescore`` batch, and at OV-LVIS (1203 x 1000,
   shared and per-class boxes) on one and two images, each entry's
   outputs also held to the entry with the plain version on the card and
   (for one OV-COCO image and the RPN's) on the CPU; and adversarial cases
   (score ties, a 2,000-box suppression chain, zero-area and identical
   boxes, n of 1, 63, 64 and 65, all dead, a small cap, boxes with NaN
   coordinates, which suppress nothing, in ``nms`` and in one image of an
   OV-COCO ``multiclass_nms`` batch). Each call's plan logged
   (``ops/nms.py:nms_plan``: blocks a problem, threads, tile); each
   main-path shape timed (device and events ms) beside the plain version,
   with its bound (bytes over 3.35 TB/s, or 14 fp32 operations an IoU
   pair the inputs need over 67 TFLOP/s) and the kernel's clock cycles by
   part (tests against the kept list, column words, the barriers,
   decisions); no PyTorch call computes greedy NMS, so no library time.
   Then the preprocessing and patch embedding kernels (``check_embed``) at
   an objects dispatch (2 images x 1024 crops at pad 640, tap bucket 35,
   with identity crops, crops past every edge, a pixel wide and
   sqrt(8)-expanded whole images) and a globals dispatch (16 paired 640 x
   480 images): ``resize_crops`` (``csrc/preprocess.cu``; its taps
   bit-identical to ``device_coeffs`` on the card and on the CPU, its
   pixels equal to its plain version's but for at most 1e-5 of them one
   uint8 step off, the count printed; the library route is the dense
   route it replaced), ``patch_rows`` (``csrc/embed.cu``, bit-identical;
   library ``F.unfold``, held to the same rows and timed with CUDA events
   alone), the patch product on ``ln_gemm`` (library
   ``F.linear``), ``embed_ln_pre`` (``csrc/embed.cu``) and the whole
   embedding before layer 0 against the block-product route (cosine >=
   0.999, max abs printed; library ``F.conv2d``), each timed with its
   bound (bytes, or for ``resize_crops`` the fp32 tap products this run's
   crops need over 67 TFLOP/s); ``F.unfold``'s device time comes from a
   child ``profile_kernels.py --only unfold`` (profiled in this process
   it emptied later profiler sessions). Last in this phase, after every
   profiled check, every ``ln_gemm`` plan (``GEMM_RATES``: the cooperative widths and
   ping-pong) on the four few-tile or deep-K launches (``check_plans``):
   the patch product at the globals (784 rows) and objects (401,408)
   dispatches, the globals x-stream proj (800 rows, K = 3072, residual)
   and kernel 2's proj (2048 rows), each through ``_ln_gemm(plan=...)``
   against its plain version (cosine >= 0.999; the residual launches on
   ``out - x`` too), timed with CUDA events;
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

The last two lines are the ``kernels`` JSON line and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import dataclasses
import gzip
import json
import math
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

D, HEADS, HD = 768, 12, 64
N_OBJ, N_GLOB = 197, 50
OBJ_BATCH, GLOB_BATCH = 2048, 16  # crops per objects dispatch, images per globals
BLOCKS_BATCH = 24 + 704  # wholes + flat blocks of a 24-image blocks dispatch
SPLIT_BATCH = 999  # crops of the split-wiring objects_step (B % 8 != 0)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12  # H100 SXM: dense bf16, HBM3
PEAK_FP32 = 67e12  # H100 SXM, fp32 outside the tensor cores
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


def timed(fn, iters: int) -> float:
    """Milliseconds per call on the card, by CUDA events after a warm-up."""
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


def device_ms(fn, iters: int, part_of=None) -> float | tuple[float, dict]:
    """Milliseconds of device time per call: the durations of the CUDA
    kernels that ``iters`` calls launched, from ``torch.profiler``, after
    a warm-up call. With ``part_of`` (a kernel's name -> the part it
    belongs to), also each part's milliseconds per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # a profiling session once returned no kernel records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0:
            break
        log(f'device_ms: profiler session {attempt + 1} of 3 recorded no device time')
    else:
        raise AssertionError('torch.profiler recorded no device time in three sessions')
    if part_of is None:
        return total_us / iters / 1e3
    split = {}
    for e in events:
        part = part_of(e.key)
        split[part] = split.get(part, 0.0) + e.self_device_time_total / iters / 1e3
    return total_us / iters / 1e3, split


# the parts of a kernel's device time, by profile_kernels' name of each
# kernel: kernels 1 and 3 (the LN pass, kernel 3's fused QKV product and
# attention, the QKV product, attention, the out-projection: ln_gemm with
# the residual epilogue), and ln_mlp_residual (the LN pass, fc with the
# quick_gelu epilogue, proj with the residual epilogue)
LAYER_PARTS = {'ln_qkv_attention_kernel': 'qkv_attention', 'layer_norm_kernel': 'ln',
               'attention_kernel': 'attention', 'ln_gemm': 'qkv',
               'ln_gemm_residual': 'out_projection'}
MLP_PARTS = {'layer_norm_kernel': 'ln', 'ln_gemm_gelu': 'fc_gelu',
             'ln_gemm_residual': 'proj_residual'}


def parts_of(parts: dict):
    """A kernel's name -> its part in ``parts``, or ``other``."""
    from oadp_torch.profile_kernels import _kernel_part

    return lambda name: parts.get(_kernel_part(name), 'other')


def compare(got, want) -> tuple[float, float]:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err, cos = 0.0, 1.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError('kernel output is not finite')
        err = max(err, float((g - w).abs().max()))
        cos = min(cos, float(F.cosine_similarity(
            g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
        ).min()))
    return err, cos


# the most that an output of rows with a large mean may differ from its
# plain version beyond one bf16 unit in the last place: on random rows
# the residual deltas of the H100's kernels differ by at most 0.0625,
# where an MLP or attention delta left out or gone wrong differs by
# several tenths to units
LARGE_MEAN_EXCESS = 0.125


def bf16_excess(got, want) -> float:
    """The largest ``|got - want|`` beyond one bf16 unit in the last place
    of the larger of the two: what is left of the error once each side's
    rounding of ``x + delta`` to bf16 is taken out. On rows with a large
    mean the residual ``x`` swamps a delta's error in a cosine; in this
    measure the delta's error stands alone."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() - ulp).max())


def plans_of(A, fn) -> list[dict]:
    """The ``ln_gemm`` plans (schedule and tile width) that one call
    of ``fn`` launches, in order."""
    taken, launch = [], A._ln_gemm

    def recorded(*args, **kwargs):
        taken.append(launch(*args, **kwargs))
        return taken[-1]

    A._ln_gemm = recorded
    try:
        fn()
    finally:
        A._ln_gemm = launch
    return [p._asdict() for p in taken]


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def _split(t, b, n):
    return t.reshape(b, n, HEADS, HD).transpose(1, 2)


def _merge(t):
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


def record_kernel(A, name, kernel, plain, library, flops, nbytes, iters, part_of=None,
                  peak=PEAK_FLOPS, profile_library=True, **extra):
    """One kernel's check and times: its output against its plain
    version's (cosine >= 0.999), then CUDA-event and device ms of the
    kernel and of the library call (None where no PyTorch call computes
    the function; its device ms None too without ``profile_library``),
    the plain version's ms, the bound (operations over ``peak``, or bytes)
    and each ``ln_gemm`` launch's plan; logged as a ``kernel_check``
    line."""
    got, want = kernel(), plain()
    err, cos = compare(got, want)
    del got, want
    if cos < 0.999:
        raise AssertionError(f'{name}: cosine {cos} < 0.999 against the plain version')
    b_ms, b_by = bound_ms(flops, nbytes, peak)
    dev = device_ms(kernel, iters, part_of)
    if part_of is not None:
        dev, extra['kernel_device_ms_by_part'] = dev
    res = dict(
        name=name, max_abs_err=err, cosine=cos, plans=plans_of(A, kernel),
        kernel_ms=timed(kernel, iters), plain_ms=timed(plain, max(2, iters // 4)),
        library_ms=None if library is None else timed(library, iters),
        bound_ms=b_ms, bound_by=b_by, kernel_device_ms=dev,
        library_device_ms=(device_ms(library, iters)
                           if library is not None and profile_library else None),
        **extra,
    )
    log(json.dumps({'kernel_check': res}))
    torch.cuda.empty_cache()
    return res


def check_kernels(A, gen) -> dict:
    dev = torch.device('cuda')

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).bfloat16()

    ln_s, ln_b = 1 + r(D, scale=0.1), r(D, scale=0.1)
    qkv_w, qkv_b = r(D, 3 * D, scale=D ** -0.5), r(3 * D, scale=0.02)
    out_w, out_b = r(D, D, scale=D ** -0.5), r(D, scale=0.02)
    fc_w, fc_b = r(D, 4 * D, scale=D ** -0.5), r(4 * D, scale=0.02)
    proj_w, proj_b = r(4 * D, D, scale=(4 * D) ** -0.5), r(D, scale=0.02)
    # K-major (out, in) copies, made once: the kernels' prepared weights
    # (as models/clip.py:prepare_kernel_params makes them) and the library
    # yardstick's F.linear weights are the same tensors
    lib_w = {k: A.kmajor(v) for k, v in dict(
        qkv=qkv_w, out=out_w, fc=fc_w, proj=proj_w).items()}
    ln32 = A.ln_fp32(ln_s, ln_b)
    w_bytes = 2 * (qkv_w.numel() + qkv_b.numel() + 2 * D)
    results = {}

    def offset(t):
        """Rows as a CLIP residual stream carries them: a per-row offset in
        [-50, 50] and a few columns at +-100, beside the random ones."""
        return (t.float() + torch.empty(*t.shape[:-1], 1, device=dev).uniform_(
            -50, 50, generator=gen) + 100 * (torch.arange(D, device=dev) % 256 == 3)).bfloat16()

    def record(*args, **kwargs):
        return record_kernel(A, *args, **kwargs)

    # kernel 1: every objects layer, fold_out (11 of 12) and side-only (last)
    b, n = OBJ_BATCH, N_OBJ
    x, y = r(b, n, D), r(b, D)
    mask = torch.rand(b, n - 1, device=dev, generator=gen) > 0.5
    bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
    args = (x, y, bias, ln_s, ln_b, qkv_w, qkv_b, HEADS, HD ** -0.5)
    lib_mask = bias[:, None, None, :].bfloat16()

    def lib_k1(with_main):
        hx, hy = F.layer_norm(x, (D,), ln_s, ln_b), F.layer_norm(y, (D,), ln_s, ln_b)
        q, k, v = (_split(t, b, n) for t in F.linear(hx, lib_w['qkv'], qkv_b).split(D, -1))
        qy, ky, vy = (t.reshape(b, HEADS, 1, HD)
                      for t in F.linear(hy, lib_w['qkv'], qkv_b).split(D, -1))
        side = F.scaled_dot_product_attention(
            qy, torch.cat([k[:, :, 1:], ky], 2), torch.cat([v[:, :, 1:], vy], 2),
            attn_mask=lib_mask,
        ).reshape(b, 1, D)
        if not with_main:
            return side
        main = _merge(F.scaled_dot_product_attention(q, k, v))
        proj = F.linear(torch.cat([main, side], 1), lib_w['out'], out_b)
        return proj + torch.cat([x, y[:, None]], 1)

    act_bytes = 2 * (x.numel() + y.numel()) + 4 * bias.numel()
    fold = dict(out_w=out_w, out_b=out_b)
    prep = dict(qkv_wt=lib_w['qkv'], ln32=ln32)
    lm_args = (offset(x), offset(y), *args[2:])
    lm_got = A.fused_surgery_layer(*lm_args, **fold, **prep, out_wt=lib_w['out'])
    lm_want = A.fused_surgery_layer_plain(*lm_args, **fold)
    (lm_err, lm_cos), lm_excess = compare(lm_got, lm_want), max(
        bf16_excess(g, w) for g, w in zip(lm_got, lm_want))
    if lm_cos < 0.999 or lm_excess > LARGE_MEAN_EXCESS:
        raise AssertionError(f'fused_surgery_layer: cosine {lm_cos} < 0.999 or bf16 excess '
                             f'{lm_excess} > {LARGE_MEAN_EXCESS} on large-mean rows')
    del lm_args, lm_got, lm_want
    k1 = record(
        'fused_surgery_layer',
        lambda: A.fused_surgery_layer(*args, **fold, **prep, out_wt=lib_w['out']),
        lambda: A.fused_surgery_layer_plain(*args, **fold),
        lambda: lib_k1(True),
        flops=2 * b * (n + 1) * D * 3 * D + 4 * b * HEADS * n * n * HD
        + 4 * b * HEADS * n * HD + 2 * b * (n + 1) * D * D,
        nbytes=2 * act_bytes - 4 * bias.numel() + w_bytes + 2 * (D * D + D),
        iters=5, part_of=parts_of(LAYER_PARTS), large_mean_max_abs_err=lm_err,
        large_mean_cosine=lm_cos, large_mean_bf16_excess=lm_excess,
    )
    k1_side = record(
        'fused_surgery_layer(with_main=False)',
        lambda: A.fused_surgery_layer(*args, with_main=False, **prep),
        lambda: A.fused_surgery_layer_plain(*args, with_main=False),
        lambda: lib_k1(False),
        flops=2 * b * n * D * 2 * D + 2 * b * D * 3 * D + 4 * b * HEADS * n * HD,
        nbytes=act_bytes + 2 * y.numel() + w_bytes,
        iters=5, part_of=parts_of(LAYER_PARTS),
    )
    del x, y, bias, mask, lib_mask, args
    torch.cuda.empty_cache()

    # kernel 2: the side-stream MLP of every objects layer
    yy = r(OBJ_BATCH, D)
    mlp = (yy, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b)

    def lib_k2():
        h = F.linear(F.layer_norm(yy, (D,), ln_s, ln_b), lib_w['fc'], fc_b)
        return yy + F.linear(h * torch.sigmoid(1.702 * h), lib_w['proj'], proj_b)

    k2 = record(
        'fused_ln_mlp_rows',
        lambda: A.fused_ln_mlp_rows(*mlp, fc_wt=lib_w['fc'], proj_wt=lib_w['proj'],
                                    ln32=ln32),
        lambda: A.fused_ln_mlp_rows_plain(*mlp),
        lib_k2,
        flops=4 * OBJ_BATCH * D * 4 * D,
        nbytes=2 * (2 * yy.numel() + fc_w.numel() + proj_w.numel() + 6 * D),
        iters=50,
    )

    # the fused layers' glue on ln_gemm: the x-stream MLP (ln_mlp_residual,
    # 11 an objects dispatch, 12 a globals or blocks dispatch) at the
    # objects, blocks and globals rows, and the stock encoder's
    # out-projection (out_proj_residual, 12 a globals or blocks dispatch)
    # at the blocks and globals rows; ln_gemm picks its tile width by M
    mlp_prep = dict(fc_wt=lib_w['fc'], proj_wt=lib_w['proj'], ln32=ln32)
    mlp_w_bytes = 2 * (fc_w.numel() + fc_b.numel() + proj_w.numel() + proj_b.numel()) + 8 * D
    xs, op = {}, {}
    for b5, n5 in ((OBJ_BATCH, N_OBJ), (BLOCKS_BATCH, N_GLOB), (GLOB_BATCH, N_GLOB)):
        m5 = b5 * n5
        iters5 = {OBJ_BATCH: 5, BLOCKS_BATCH: 20, GLOB_BATCH: 50}[b5]
        xm, am = r(b5, n5, D), r(b5, n5, D)
        mlp_args = (xm, ln_s, ln_b, fc_w, fc_b, proj_w, proj_b)
        entries = {'ln_mlp_residual': (lambda: A.ln_mlp_residual(*mlp_args, **mlp_prep),
                                       lambda: A.ln_mlp_residual_plain(*mlp_args))}
        if b5 != OBJ_BATCH:  # no objects layer takes out_proj_residual
            entries['out_proj_residual'] = (
                lambda: A.out_proj_residual(xm, am, out_w, out_b, out_wt=lib_w['out']),
                lambda: A.out_proj_residual_plain(xm, am, out_w, out_b))

        def lib_mlp():  # the route before ln_gemm took it: F.layer_norm, cuBLAS, quick_gelu, add
            h = F.linear(F.layer_norm(xm, (D,), ln_s, ln_b), lib_w['fc'], fc_b)
            return xm + F.linear(h * torch.sigmoid(1.702 * h), lib_w['proj'], proj_b)

        # the residual deltas too: the output's x would hide the MLP's error
        delta = {}
        for name, (kernel, plain) in entries.items():
            delta[name] = compare(kernel().float() - xm.float(), plain().float() - xm.float())
            if delta[name][1] < 0.999:
                raise AssertionError(f'{name}(M={m5}): residual delta cosine {delta[name][1]}')
        # on large-mean rows the output's rounding swamps the delta: held
        # beyond one bf16 unit in the last place instead
        lm5 = (offset(xm), *mlp_args[1:])
        lm_got, lm_want = A.ln_mlp_residual(*lm5, **mlp_prep), A.ln_mlp_residual_plain(*lm5)
        (lm_err, lm_cos), lm_excess = compare(lm_got, lm_want), bf16_excess(lm_got, lm_want)
        if lm_cos < 0.999 or lm_excess > LARGE_MEAN_EXCESS:
            raise AssertionError(f'ln_mlp_residual(M={m5}): cosine {lm_cos} < 0.999 or bf16 '
                                 f'excess {lm_excess} > {LARGE_MEAN_EXCESS} on large-mean rows')
        del lm5, lm_got, lm_want
        xs[b5] = record(
            f'ln_mlp_residual(M={m5})', *entries['ln_mlp_residual'], lib_mlp,
            flops=4 * m5 * D * 4 * D,
            nbytes=2 * 2 * xm.numel() + mlp_w_bytes,  # x read, out written, the weights
            iters=iters5, part_of=parts_of(MLP_PARTS),
            residual_delta_max_abs_err=delta['ln_mlp_residual'][0],
            residual_delta_cosine=delta['ln_mlp_residual'][1],
            large_mean_max_abs_err=lm_err, large_mean_cosine=lm_cos,
            large_mean_bf16_excess=lm_excess,
        )
        if 'out_proj_residual' in entries:
            op[b5] = record(
                f'out_proj_residual(M={m5})', *entries['out_proj_residual'],
                lambda: xm + F.linear(am, lib_w['out'], out_b),
                flops=2 * m5 * D * D,
                nbytes=2 * (3 * xm.numel() + D * D + D),  # x and a read, out written, W and b
                iters=iters5,
                residual_delta_max_abs_err=delta['out_proj_residual'][0],
                residual_delta_cosine=delta['out_proj_residual'][1],
            )
        del xm, am, mlp_args, entries
        torch.cuda.empty_cache()

    # kernel 3: every layer of the stock encoder, at the globals batch and
    # at a production blocks batch (24 wholes + 704 blocks)
    n3 = N_GLOB
    k3 = {}
    for b3 in (GLOB_BATCH, BLOCKS_BATCH):
        x3 = r(b3, n3, D)
        a3 = (x3, ln_s, ln_b, qkv_w, qkv_b, HEADS, HD ** -0.5)

        def lib_k3():
            hx = F.layer_norm(x3, (D,), ln_s, ln_b)
            q, k, v = (_split(t, b3, n3) for t in F.linear(hx, lib_w['qkv'], qkv_b).split(D, -1))
            return _merge(F.scaled_dot_product_attention(q, k, v))

        lm3 = (offset(x3), *a3[1:])
        lm_err, lm_cos = compare(A.fused_ln_qkv_attention(*lm3, **prep),
                                 A.fused_ln_qkv_attention_plain(*lm3))
        if lm_cos < 0.999:
            raise AssertionError(
                f'fused_ln_qkv_attention(B={b3}): cosine {lm_cos} < 0.999 on large-mean rows')
        del lm3
        k3[b3] = record(
            f'fused_ln_qkv_attention(B={b3})',
            lambda: A.fused_ln_qkv_attention(*a3, **prep),
            lambda: A.fused_ln_qkv_attention_plain(*a3),
            lib_k3,
            flops=2 * b3 * n3 * D * 3 * D + 4 * b3 * HEADS * n3 * n3 * HD,
            nbytes=2 * 2 * x3.numel() + w_bytes,
            iters=50 if b3 == GLOB_BATCH else 10, part_of=parts_of(LAYER_PARTS),
            large_mean_max_abs_err=lm_err, large_mean_cosine=lm_cos,
        )
        del x3, a3

    # kernels 4 and 5: the split wiring's attention, on the packed qkv of
    # a layer (K and V are column slices, row stride 3D) at the split
    # path's batch and at the objects dispatch's
    k4, k5 = {}, {}
    for b in (SPLIT_BATCH, OBJ_BATCH):
        n = N_OBJ
        qkv, qkv_y = r(b, n, 3 * D), r(b, 3 * D)
        mask = torch.rand(b, n - 1, device=dev, generator=gen) > 0.5
        bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
        q, k, v = qkv.split(D, -1)
        qy, ky, vy = qkv_y.split(D, -1)
        side_args = (k, v, qy, ky, vy, bias, HEADS)
        lib_mask = bias[:, None, None, :].bfloat16()

        def lib_k4():
            return _merge(F.scaled_dot_product_attention(*(_split(t, b, n) for t in (q, k, v))))

        def lib_k5():
            heads_y = [t.reshape(b, HEADS, 1, HD) for t in (qy, ky, vy)]
            kk, vv = (torch.cat([_split(t, b, n)[:, :, 1:], ty], 2)
                      for t, ty in ((k, heads_y[1]), (v, heads_y[2])))
            return F.scaled_dot_product_attention(heads_y[0], kk, vv, attn_mask=lib_mask)

        k4[b] = record(
            f'fused_mha_qkv(B={b})',
            lambda: A.fused_mha_qkv(qkv, HEADS, HD ** -0.5),
            lambda: A.fused_mha_qkv_plain(qkv, HEADS, HD ** -0.5),
            lib_k4,
            flops=4 * b * HEADS * n * n * HD,
            nbytes=2 * 4 * b * n * D,  # q, k, v read, the output written
            iters=5,
        )
        k5[b] = record(
            f'fused_side_attention(B={b})',
            lambda: A.fused_side_attention(*side_args),
            lambda: A.fused_side_attention_plain(*side_args),
            lib_k5,
            flops=4 * b * n * D,
            nbytes=2 * (2 * b * (n - 1) * D + 4 * b * D) + 4 * bias.numel(),
            iters=20,
        )
        del qkv, qkv_y, bias, mask, q, k, v, qy, ky, vy, side_args, lib_mask
        torch.cuda.empty_cache()

    results.update({
        'fused_surgery_layer': dict(k1, side_only=k1_side),
        'fused_ln_mlp_rows': k2,
        'fused_ln_qkv_attention': dict(k3[GLOB_BATCH], blocks_batch=k3[BLOCKS_BATCH]),
        'fused_mha_qkv': dict(k4[SPLIT_BATCH], objects_batch=k4[OBJ_BATCH]),
        'fused_side_attention': dict(k5[SPLIT_BATCH], objects_batch=k5[OBJ_BATCH]),
        'ln_mlp_residual': dict(xs[OBJ_BATCH], blocks_batch=xs[BLOCKS_BATCH],
                                globals_batch=xs[GLOB_BATCH]),
        'out_proj_residual': dict(op[BLOCKS_BATCH], globals_batch=op[GLOB_BATCH]),
    })
    return results


# ---------------------------------------------------------------------------
# Phase 3, continued: attention past 256 tokens (CLIP ViT-L/14's surgery)
# ---------------------------------------------------------------------------

L14_D, L14_HEADS, N_L14 = 1024, 16, 1025  # width, heads, tokens of a surgery crop


def _surgery_layer_args(gen, b: int, n: int, heads: int):
    """Random bf16 inputs of one surgery layer (x, y, bias, LN, QKV) and
    its out-projection, with -100 on a random half of the patches."""
    dev, d = torch.device('cuda'), heads * HD

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).bfloat16()

    mask = torch.rand(b, n - 1, device=dev, generator=gen) > 0.5
    bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
    args = (r(b, n, d), r(b, d), bias, 1 + r(d, scale=0.1), r(d, scale=0.1),
            r(d, 3 * d, scale=d ** -0.5), r(3 * d, scale=0.02), heads, HD ** -0.5)
    return args, dict(out_w=r(d, d, scale=d ** -0.5), out_b=r(d, scale=0.02))


def short_and_long_at_n_obj(A, gen) -> dict:
    """Both attention kernels at B/32's objects dispatch (2048 crops x 197
    tokens x 12 heads, main rows and side row in one launch): ``attention``,
    which the route keeps up to 256 tokens, and ``long_attention`` (routed
    there for this call by lowering the route's threshold), each against
    the plain version a chunk of crops at a time, and their device times."""
    dev = torch.device('cuda')
    b, n, d, heads = OBJ_BATCH, N_OBJ, D, HEADS
    scale = HD ** -0.5
    qkv = (torch.randn(b, n, 3 * d, device=dev, generator=gen) * 2).bfloat16()
    qkv_y = (torch.randn(b, 3 * d, device=dev, generator=gen) * 2).bfloat16()
    mask = torch.rand(b, n - 1, device=dev, generator=gen) > 0.5
    bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
    q, k, v = qkv.split(d, -1)
    qy, ky, vy = qkv_y.split(d, -1)
    main = torch.empty((b, n, d), dtype=torch.bfloat16, device=dev)
    side = torch.empty((b, d), dtype=torch.bfloat16, device=dev)

    def kernel():
        A._attention(q, k, v, heads, scale, out=main, qy=qy, ky=ky, vy=vy, bias=bias, side=side)

    res = dict(name=f'attention vs long_attention(B={b}, N={n}, heads={heads})')
    short_limit = A._MAX_TOKENS
    try:
        for route, limit in (('attention', short_limit), ('long_attention', 0)):
            A._MAX_TOKENS = limit
            A.reset_launches()
            main.zero_()
            side.zero_()
            kernel()
            torch.cuda.synchronize()
            if A.ROUTES[route] != 1:
                raise AssertionError(f'{route}: routes {A.ROUTES} at N = {n}')
            err, cos = 0.0, 1.0
            for c in range(0, b, 256):
                sl = slice(c, c + 256)
                e, co = compare((main[sl], side[sl]), (
                    A._main_attention(qkv[sl], heads, scale),
                    A._side_attention(k[sl], v[sl], qy[sl], ky[sl], vy[sl], bias[sl], heads,
                                      scale)))
                err, cos = max(err, e), min(cos, co)
            if cos < 0.999:
                raise AssertionError(f'{route} at N = {n}: cosine {cos} against the plain version')
            res[route] = dict(max_abs_err=err, cosine=cos, device_ms=device_ms(kernel, 5))
    finally:
        A._MAX_TOKENS = short_limit
    res['long_over_short'] = res['long_attention']['device_ms'] / res['attention']['device_ms']
    log(json.dumps({'short_and_long_at_n_obj': res}))
    torch.cuda.empty_cache()
    return res


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


def check_long_attention(A, gen) -> dict:
    """``long_attention`` (``csrc/long_attention.cu``) at an L/14 objects
    dispatch (2048 crops x 1,025 tokens x 16 heads): first its ptxas
    report (no serialised wgmma, no spill: :func:`long_attention_build`);
    the main rows and the side row of one launch against the plain version
    a chunk of crops at a time (its fp32 logits of the whole dispatch would
    take 137 GB), its time beside the bound of the launch's work and
    ``F.scaled_dot_product_attention`` at the same shapes (main rows, and
    the side row with its mask, on contiguous per-head copies made
    beforehand); the side row alone (the last layer) checked and timed;
    one whole L/14 surgery layer's device time by part; then an L/14 layer
    and its side-only last layer traced and held to the benchmark's launch
    check (``benchmark/trace.py:check_launches``), and a B/32 layer that
    launches the short kernel alone; last, both kernels at B/32's shapes
    (:func:`short_and_long_at_n_obj`). Logged as a ``long_attention_check``
    line."""
    from benchmark import trace as T
    from benchmark.metrics import kernel_parts

    build = long_attention_build()
    dev = torch.device('cuda')
    b, n, d, heads = OBJ_BATCH, N_L14, L14_D, L14_HEADS
    scale = HD ** -0.5
    qkv = (torch.randn(b, n, 3 * d, device=dev, generator=gen) * 2).bfloat16()
    qkv_y = (torch.randn(b, 3 * d, device=dev, generator=gen) * 2).bfloat16()
    mask = torch.rand(b, n - 1, device=dev, generator=gen) > 0.5
    bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
    q, k, v = qkv.split(d, -1)
    qy, ky, vy = qkv_y.split(d, -1)
    main = torch.empty((b, n, d), dtype=torch.bfloat16, device=dev)
    side = torch.empty((b, d), dtype=torch.bfloat16, device=dev)

    def kernel():
        A._attention(q, k, v, heads, scale, out=main, qy=qy, ky=ky, vy=vy, bias=bias, side=side)

    A.reset_launches()
    kernel()
    torch.cuda.synchronize()
    if A.ROUTES != {'attention': 0, 'long_attention': 1}:
        raise AssertionError(f'long_attention: routes {A.ROUTES} at N = {n}')
    # two bf16 units in the last place of the largest output: both round
    # fp32 sums taken in another order, so a rounding may fall either way
    err, cos, ulps = 0.0, 1.0, 0.0
    for c in range(0, b, 64):
        sl = slice(c, c + 64)
        want = (A._main_attention(qkv[sl], heads, scale),
                A._side_attention(k[sl], v[sl], qy[sl], ky[sl], vy[sl], bias[sl], heads, scale))
        e, co = compare((main[sl], side[sl]), want)
        top = max(float(w.abs().max()) for w in want)
        err, cos = max(err, e), min(cos, co)
        ulps = max(ulps, e / 2.0 ** (math.floor(math.log2(top)) - 7))
    if cos < 0.999 or ulps > 2:
        raise AssertionError(f'long_attention: cosine {cos}, max error {err} ({ulps} units) '
                             'against the plain version')
    flops = 4 * b * heads * n * n * HD + 4 * b * heads * n * HD
    nbytes = 2 * (4 * b * n * d + 4 * b * d) + 4 * b * n
    b_ms, b_by = bound_ms(flops, nbytes)
    res = dict(name=f'long_attention(B={b}, N={n}, heads={heads})', max_abs_err=err,
               max_bf16_units=ulps, cosine=cos, bound_ms=b_ms, bound_by=b_by,
               kernel_ms=timed(kernel, 3), kernel_device_ms=device_ms(kernel, 3))
    res['bound_share'] = res['bound_ms'] / res['kernel_device_ms']
    res['build'] = build
    del main

    # the side row alone (the last layer): K and V streamed once an item
    def side_only():
        A._attention(None, k, v, heads, scale, qy=qy, ky=ky, vy=vy, bias=bias, side=side)

    side.zero_()
    side_only()
    torch.cuda.synchronize()
    err, cos = 0.0, 1.0
    for c in range(0, b, 256):
        sl = slice(c, c + 256)
        e, co = compare(side[sl], A._side_attention(k[sl], v[sl], qy[sl], ky[sl], vy[sl],
                                                    bias[sl], heads, scale))
        err, cos = max(err, e), min(cos, co)
    if cos < 0.999:
        raise AssertionError(f'long_attention, side row alone: cosine {cos}')
    s_ms, s_by = bound_ms(4 * b * heads * n * HD, 2 * (2 * b * n * d + 4 * b * d) + 4 * b * n)
    res['side_only'] = dict(max_abs_err=err, cosine=cos, bound_ms=s_ms, bound_by=s_by,
                            kernel_ms=timed(side_only, 5), kernel_device_ms=device_ms(side_only, 5))
    res['side_only']['bound_share'] = s_ms / res['side_only']['kernel_device_ms']
    del side
    # the library yardstick on contiguous (B, heads, N, 64) copies
    q4, k4, v4 = (t.reshape(b, n, heads, HD).transpose(1, 2).contiguous() for t in (q, k, v))
    ky4, vy4 = (t.reshape(b, heads, 1, HD) for t in (ky, vy))
    kk, vv = torch.cat([k4[:, :, 1:], ky4], 2), torch.cat([v4[:, :, 1:], vy4], 2)
    qy4, lib_mask = qy.reshape(b, heads, 1, HD), bias[:, None, None, :].bfloat16()
    del qkv, qkv_y, q, k, v, qy, ky, vy
    torch.cuda.empty_cache()

    def library():
        F.scaled_dot_product_attention(q4, k4, v4)
        F.scaled_dot_product_attention(qy4, kk, vv, attn_mask=lib_mask)

    res.update(library_ms=timed(library, 3), library_device_ms=device_ms(library, 3))
    del q4, k4, v4, ky4, vy4, kk, vv, qy4, lib_mask
    torch.cuda.empty_cache()

    # one whole L/14 surgery layer (fold_out) at the dispatch, by part
    args, fold = _surgery_layer_args(gen, b, n, heads)
    layer_ms, by_part = device_ms(lambda: A.fused_surgery_layer(*args, **fold), 2,
                                  parts_of(LAYER_PARTS))
    res.update(layer_device_ms=layer_ms, layer_device_ms_by_part=by_part)
    del args, fold
    torch.cuda.empty_cache()

    # the benchmark's launch check on traced layers: L/14 takes the new
    # kernel, counted once a call; B/32 the short one alone
    traced_names = {}
    for name, tokens, h in (('l14', N_L14, L14_HEADS), ('b32', N_OBJ, HEADS)):
        args, fold = _surgery_layer_args(gen, 16, tokens, h)
        A.fused_surgery_layer(*args, **fold)
        torch.cuda.synchronize()
        session = T.Session().start()
        A.fused_surgery_layer(*args, **fold)
        A.fused_surgery_layer(*args, with_main=False)
        with tempfile.TemporaryDirectory() as tmp:
            traced = session.stop(pathlib.Path(tmp) / 'trace.json')
        if traced.launches['attention_kernel'] != [2, 2]:
            raise AssertionError(f'{name}: launch check {traced.launches}')
        traced_names[name] = sorted({k[:96]
                                     for k, _, _ in traced.kernels
                                     if kernel_parts.part(k) == 'attention_kernel'})
    if not (all('long_attention_kernel' in k for k in traced_names['l14'])
            and not any('long_attention_kernel' in k for k in traced_names['b32'])):
        raise AssertionError(f'attention kernels by width: {traced_names}')
    res['traced_attention_kernels'] = traced_names
    res['at_n_obj'] = short_and_long_at_n_obj(A, gen)
    log(json.dumps({'long_attention_check': res}))
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 3, continued: the preprocessing and patch embedding kernels
# ---------------------------------------------------------------------------

OBJ_PAD, OBJ_K, GLOB_K = 640, 35, 13  # the objects CLI's pad and largest tap bucket
#: the share of pixels that may sit one uint8 step from the plain version
#: (none further): the two sum each pixel's exact products in one order
RESIZE_STEP_SHARE = 1e-5


def _objects_crops(rng, images: int = 2, rows: int = 1024, w: int = 640, h: int = 480):
    """An objects dispatch's inputs: ``images`` random w x h images padded to
    640 and ``rows`` crops each, as the objects CLI cuts them (proposals
    expanded by ``ops/boxes.expand_boxes``), with adversarial crops in
    each image's first rows: 224 x 224 (identity), past every edge, a pixel
    wide, and sqrt(8)-expanded whole images (35 taps)."""
    from oadp_torch.ops import boxes as B
    from oadp_torch.ops import preprocess as P

    imgs = np.zeros((images, OBJ_PAD, OBJ_PAD, 3), np.uint8)
    imgs[:, :h, :w] = rng.randint(0, 256, (images, h, w, 3))
    metas = []
    for _ in range(images):
        x0, y0 = rng.uniform(0, w * .8, rows), rng.uniform(0, h * .8, rows)
        props = np.stack([x0, y0, np.minimum(x0 + rng.uniform(8, w * .5, rows), w),
                          np.minimum(y0 + rng.uniform(8, h * .5, rows), h)], -1)
        crops = B.expand_boxes(props.astype(np.float32), w, h).astype(np.float64)
        side = np.sqrt(8.0) * OBJ_PAD
        crops[:12] = [[10, 20, 234, 244], [-30, -20, 194, 204], [-50, -40, w + 30, h + 60],
                      [w - 20, h - 30, w + 90, h + 40], [-90, 100, 5, 300], [100.5, 50, 101.5, 150],
                      [300, 10.2, 301.2, 400], [0, 0, w, h],
                      [w / 2 - side / 2, h / 2 - side / 2, w / 2 + side / 2, h / 2 + side / 2],
                      [w / 2 - side * .45, h / 2 - side / 2, w / 2 + side * .45, h / 2 + side * .4],
                      [-side / 2, -side / 3, side / 2, side / 2], [0, 0, 8, 300]]
        metas.append(P.clip_transform_meta(w, h, crops))
    return imgs, np.concatenate(metas)


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


def check_embed(gen) -> dict:
    """The objects and globals dispatches' preprocessing and patch embedding
    kernels against their plain versions on the card: ``resize_crops`` (its
    taps bit-identical to ``device_coeffs``, its pixels equal but for at
    most ``RESIZE_STEP_SHARE`` of them one uint8 step off), ``patch_rows``
    (bit-identical), the patch product on ``ln_gemm`` and ``embed_ln_pre``
    (cosine >= 0.999), and the whole embedding before layer 0 against the
    block-product route (cosine >= 0.999); each timed beside its plain
    version, the library route and its bound."""
    from oadp_torch.models import clip as C
    from oadp_torch.oake import encoders as E
    from oadp_torch.ops import attention as A
    from oadp_torch.ops import embed as EM
    from oadp_torch.ops import preprocess as P
    from oadp_torch.profile_kernels import _dense_crops

    dev = torch.device('cuda')
    rng = np.random.RandomState(0)
    results = {}
    t_phase = time.perf_counter()

    # resize_crops: an objects dispatch (2 images x 1024 crops, k_pad 35)
    # and a globals dispatch (16 paired 640 x 480 images, whole, k_pad 13)
    imgs, meta = _objects_crops(rng)
    gimgs = np.zeros((GLOB_BATCH, OBJ_PAD, OBJ_PAD, 3), np.uint8)
    gimgs[:, :480] = rng.randint(0, 256, (GLOB_BATCH, 480, 640, 3))
    gmeta = np.repeat(P.clip_transform_meta(640, 480, np.asarray([[0.0, 0, 640, 480]])),
                      GLOB_BATCH, 0)
    resize = {}
    for label, images, m, k in (('objects', imgs, meta, OBJ_K), ('globals', gimgs, gmeta, GLOB_K)):
        images, m = torch.from_numpy(images).to(dev), torch.from_numpy(m).to(dev)
        crops, taps = P.resize_crops(images, m, k, return_taps=True)
        want_taps = P.device_coeffs(m, k)
        cpu_taps = P.device_coeffs(m.cpu(), k)
        for got, want, cpu in zip(taps, want_taps, cpu_taps):
            if not torch.equal(got, want) or not torch.equal(got.cpu(), cpu):
                raise AssertionError(f'resize_crops({label}): taps differ from device_coeffs in '
                                     f'{int((got != want).sum())} (card) / '
                                     f'{int((got.cpu() != cpu).sum())} (CPU) places')
        zero, one = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
        px = P.resize_crops(images, m, k, zero, one).float()
        px_plain = P.resize_crops_plain(images, m, k, zero, one).float()
        steps = (px - px_plain).abs()
        off = int((steps > 0).sum())
        if float(steps.max()) > 1 or off > RESIZE_STEP_SHARE * steps.numel():
            raise AssertionError(f'resize_crops({label}): {off} pixels off the plain version, '
                                 f'the most by {float(steps.max())} steps')
        del px, px_plain, steps
        nbytes = images.numel() + m.numel() * 4 + crops.numel() * 2
        resize[label] = record_kernel(
            A, f'resize_crops({label}: {len(m)} crops, k_pad {k})',
            lambda: P.resize_crops(images, m, k), lambda: P.resize_crops_plain(images, m, k),
            lambda: _dense_crops(images, m, k),
            _tap_work(taps, images.shape[1], images.shape[2]), nbytes,
            iters=10 if label == 'objects' else 50, peak=PEAK_FP32,
            taps_identical=True, pixels_one_step_off=off, pixels=crops.numel())
        results.setdefault('crops', {})[label] = crops
        del images, m, taps, want_taps, crops

    # patch_rows, the product and embed_ln_pre at the surgery encoder's
    # half stride (the objects crops) and the stock encoder's stride (the
    # globals crops), random ViT-B/32 weights from seed 0, bf16
    model = E.load_clip(None, 'bfloat16', device=dev)
    embed = {}
    for label, params, cfg in (('objects', model.surgery_params, model.surgery_config),
                               ('globals', model.params, model.config)):
        crops = results['crops'][label]
        p, s, d, g = cfg.patch_size, cfg.stride, cfg.width, cfg.grid
        b = crops.shape[0]
        kern = params['kernel']
        rows = EM.patch_rows(crops, p, s)
        if not torch.equal(rows, EM.patch_rows_plain(crops, p, s)):
            raise AssertionError(f'patch_rows({label}): differs from its plain version')
        iters = 10 if label == 'objects' else 50
        pad, _ = EM.patch_geometry(crops.shape[1], p, s)
        # the library call: F.unfold's (B, 3 * P * P, L) columns, in the
        # same (c, i, j) order, as (B * L, 3 * P * P) rows; CUDA events
        # only, as its im2col is a launch a crop (2048 a call), whose
        # profile left the next torch.profiler sessions empty
        def unfold():
            cols = F.unfold(crops.permute(0, 3, 1, 2), p, padding=pad, stride=s)
            return cols.transpose(1, 2).reshape(-1, 3 * p * p)

        if not torch.equal(unfold(), rows):
            raise AssertionError(f'patch_rows({label}): F.unfold gives other rows')
        r_rows = record_kernel(
            A, f'patch_rows({label}: {b} crops, stride {s})', lambda: EM.patch_rows(crops, p, s),
            lambda: EM.patch_rows_plain(crops, p, s), unfold,
            0.0, crops.numel() * 2 + rows.numel() * 2, iters, profile_library=False,
            identical=True)
        x = EM.patch_embed(rows, kern['conv1_wt'], kern['conv1_b'])
        r_prod = record_kernel(
            A, f'patch_embed({label}: M={rows.shape[0]}, K={rows.shape[1]}, N={d})',
            lambda: EM.patch_embed(rows, kern['conv1_wt'], kern['conv1_b']),
            lambda: EM.patch_embed_plain(rows, kern['conv1_wt']),
            lambda: F.linear(rows, kern['conv1_wt']),
            2.0 * rows.shape[0] * rows.shape[1] * d,
            rows.numel() * 2 + kern['conv1_wt'].numel() * 2 + x.numel() * 2, iters)
        del rows
        x = x.view(b, g * g, d)
        ln = params['ln_pre']
        ln_args = (x, params['class_embedding'], params['positional_embedding'], ln['scale'],
                   ln['bias'])
        r_ln = record_kernel(
            A, f'embed_ln_pre({label}: {b} x {g * g + 1} x {d})',
            lambda: EM.embed_ln_pre(*ln_args, ln32=kern['ln_pre']),
            lambda: EM.embed_ln_pre_plain(*ln_args), lambda: EM.embed_ln_pre_plain(*ln_args),
            0.0, x.numel() * 2 + b * (g * g + 1) * d * 2 + (g * g + 2) * d * 2 + 8 * d, iters)
        del x, ln_args

        # the whole embedding before layer 0: the kernels against the
        # block-product route (_embed_patches + ln_pre) and F.conv2d's
        def conv_route():
            y = F.conv2d(crops.permute(0, 3, 1, 2), params['conv1'], stride=s, padding=pad)
            y = y.flatten(2).transpose(1, 2)
            y = torch.cat([params['class_embedding'].expand(b, 1, d), y], 1)
            y = y + params['positional_embedding']
            return F.layer_norm(y, (d,), ln['scale'], ln['bias'], 1e-5)

        r_whole = record_kernel(
            A, f'embedding({label}: patch_rows + ln_gemm + embed_ln_pre)',
            lambda: C._embed_ln_pre(crops, params, cfg),
            lambda: C._layer_norm(C._embed_patches(crops, params, cfg), params['ln_pre']),
            conv_route, 2.0 * b * g * g * 3 * p * p * d,
            crops.numel() * 2 + b * (g * g + 1) * d * 2 + params['conv1'].numel() * 2, iters)
        embed[label] = dict(patch_rows=r_rows, patch_embed=r_prod, embed_ln_pre=r_ln,
                            embedding=r_whole)
        del crops
        torch.cuda.empty_cache()
    del results['crops'], model
    torch.cuda.empty_cache()
    log(json.dumps({'check_embed_s': time.perf_counter() - t_phase}))
    return {
        'resize_crops': dict(resize['objects'], globals_batch=resize['globals']),
        **{k: dict(embed['objects'][k], globals_batch=embed['globals'][k])
           for k in ('patch_rows', 'patch_embed', 'embed_ln_pre')},
        'embedding': dict(embed['objects']['embedding'],
                          globals_batch=embed['globals']['embedding']),
    }


def check_plans(A, gen) -> dict:
    """Every ``ln_gemm`` plan (``A.GEMM_RATES``: the cooperative widths
    and ping-pong) on the few-tile or deep-K launches: the
    patch product (K = 3072, N = 768, no epilogue) at the globals (784
    rows) and objects (401,408) dispatches, the globals x-stream proj (800
    rows) and kernel 2's proj (2048 rows; K = 3072 with the residual),
    each forced through ``_ln_gemm(plan=...)`` and held to its plain
    version (cosine >= 0.999), the residual launches also on their deltas
    ``out - x``; each plan's CUDA-event ms, beside the plan
    ``ln_gemm_plan`` picks. Raises on the first plan that fails."""
    dev = torch.device('cuda')
    launches = {'patch_embed(globals)': (GLOB_BATCH * 49, 0),
                'patch_embed(objects)': (OBJ_BATCH * 196, 0),
                'ln_mlp_residual proj(globals)': (GLOB_BATCH * N_GLOB, 2),
                'fused_ln_mlp_rows proj': (OBJ_BATCH, 2)}
    k = 4 * D
    w = (torch.randn(k, D, device=dev, generator=gen) * k ** -0.5).bfloat16()
    wt, wb = A.kmajor(w), (0.02 * torch.randn(D, device=dev, generator=gen)).bfloat16()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name, (m, epi) in launches.items():
        x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
        res = torch.randn(m, D, device=dev, generator=gen).bfloat16() if epi == 2 else None
        want = A._proj(x, w, wb) + (0 if res is None else res.float())
        got = torch.empty(m, D, device=dev, dtype=torch.bfloat16)
        by_plan = {}
        for plan in A.GEMM_RATES:
            run = lambda: A._ln_gemm(x, wt, wb, got, epilogue=epi, residual=res,  # noqa: E731
                                     plan=plan)
            run()
            err, cos = compare(got, want)
            row = dict(max_abs_err=err, cosine=cos)
            if res is not None:
                row['residual_delta_cosine'] = compare(got.float() - res.float(),
                                                       want - res.float())[1]
            if min(cos, row.get('residual_delta_cosine', 1.0)) < 0.999:
                raise AssertionError(f'ln_gemm {name} plan {plan}: cosine {row} < 0.999')
            row['ms'] = timed(run, 3 if m > 100_000 else 20)
            by_plan[f'{plan.schedule}{plan.tile_n}'] = row
        picked = A.ln_gemm_plan([(m, D)], k, epi, sms)
        out[name] = dict(rows=m, depth=k, epilogue=epi, picked=picked._asdict(),
                         by_plan=by_plan)
        log(json.dumps({'plan_check': {name: out[name]}}))
        del x, res, want, got
        torch.cuda.empty_cache()
    return out


def unfold_device_ms() -> dict:
    """``F.unfold``'s device ms (``patch_rows``' library call) at the
    objects (2048 crops, stride 16) and globals (16, stride 32) shapes,
    from ``profile_kernels.py --only unfold`` run in a child process."""
    proc = subprocess.run(
        [sys.executable, '-m', 'oadp_torch.profile_kernels', '--only', 'unfold'],
        cwd=pathlib.Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600, check=True)
    found = {}
    for line in proc.stdout.splitlines():
        if line.startswith('{"unfold"'):
            row = json.loads(line)['unfold']
            found[row['crops']] = row
    if set(found) != {OBJ_BATCH, GLOB_BATCH}:
        raise AssertionError(f'profile_kernels --only unfold printed {sorted(found)}')
    log(json.dumps({'unfold': found}))
    return found


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


# greedy_nms: the IoU of a pair and its comparison, in fp32 outside the
# tensor cores: 2 max, 2 min, 2 subtractions and 2 clamps (the overlap), 1
# product (inter), 1 addition and 1 subtraction (union), 1 clamp, 1
# division, 1 comparison
IOU_FLOP = 14
RPN_CANVAS, RPN_HW = (832, 1344), [(800, 1199), (800, 1333)]
RPN_PRE, RPN_MAX, RPN_IOU = 2000, 1000, 0.7  # the OV-COCO train config's RPN NMS


def _captured_keep(fn):
    """``fn()`` (an entry point of ``ops/nms.py``) and the arguments of each
    ``greedy_keep_sorted`` call it made."""
    from oadp_torch.ops import nms as NMS

    seen = []
    keep_fn = NMS.greedy_keep_sorted

    def capture(*a, **k):
        seen.append((a, k))
        return keep_fn(*a, **k)

    NMS.greedy_keep_sorted = capture
    try:
        out = fn()
    finally:
        NMS.greedy_keep_sorted = keep_fn
    return out, seen


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


def _rpn_inputs(gen, dev):
    """RPN head outputs at the train canvas (random logits and deltas, two
    images) with the canvas's anchors: ``rpn_proposals`` takes the top 2000
    of each level, 8,819 candidates an image."""
    from oadp_torch.ops.anchors import AnchorGenerator

    sizes = [(-(-RPN_CANVAS[0] // s), -(-RPN_CANVAS[1] // s)) for s in (4, 8, 16, 32, 64)]
    anchors = [torch.from_numpy(a).float().to(dev)
               for a in AnchorGenerator().grid_anchors(sizes)]
    scores = [torch.randn(2, len(a), device=dev, generator=gen) for a in anchors]
    deltas = [0.2 * torch.randn(2, len(a), 4, device=dev, generator=gen) for a in anchors]
    return scores, deltas, anchors, torch.tensor(RPN_HW, device=dev)


def _det_inputs(gen, dev, classes: int, per_class: bool, n: int = 1000):
    """A detector's ``n`` decoded boxes on an 800 x 1199 image, clustered
    round 40 objects, and softmax scores over ``classes`` + background,
    zero on 5% of the rows (proposals that were not valid)."""
    centre = torch.rand(40, 2, device=dev, generator=gen) * torch.tensor([1199., 800.], device=dev)
    size = 30 + 270 * torch.rand(40, 2, device=dev, generator=gen)
    k = torch.randint(0, 40, (n,), device=dev, generator=gen)
    jitter = 1 + 0.15 * torch.randn(n, 2, device=dev, generator=gen)
    c, s = centre[k], size[k] * jitter
    boxes = torch.cat([c - s / 2, c + s / 2], 1).clamp(min=0)
    if per_class:
        boxes = (boxes[:, None] + 4 * torch.randn(n, classes, 4, device=dev, generator=gen)
                 ).clamp(min=0).reshape(n, classes * 4)
    scores = torch.softmax(2 * torch.randn(n, classes + 1, device=dev, generator=gen), -1)
    scores = scores * (torch.rand(n, 1, device=dev, generator=gen) > 0.05)
    return boxes, scores


def _adversarial(gen, dev) -> dict:
    """``nms`` inputs (boxes, scores, iou, max_out) that stress the scan."""
    from oadp_torch.ops import nms as NMS

    def clustered(n):
        b, _ = _det_inputs(gen, dev, 1, False, n)
        return b

    def rand(n):
        return torch.rand(n, device=dev, generator=gen)

    chain_x = 4 * torch.arange(2000, device=dev, dtype=torch.float32)[:, None]
    chain = torch.cat([chain_x, 0 * chain_x, chain_x + 10, 0 * chain_x + 10], 1)
    mixed = clustered(1000)
    mixed[::2, 2] = mixed[::2, 0]  # zero width
    mixed[1::4] = mixed[1]  # one box, many times
    mixed[3::8] = mixed[3, :1]  # points
    nan = float('nan')
    nan_boxes = clustered(1000)
    rows = torch.arange(3, 1000, 7, device=dev)
    nan_boxes[rows, rows % 4] = nan  # one coordinate of every 7th box
    nan_boxes[500] = nan
    cases = {
        # the highest-scored box is NaN: its IoU with every box is NaN, so
        # it suppresses nothing and all three are kept
        'nan_box': (torch.tensor([[nan] * 4, [0, 0, 10, 10], [20, 20, 30, 30]], device=dev),
                    torch.tensor([0.9, 0.8, 0.7], device=dev), 0.5, 3),
        'nan_boxes': (nan_boxes, rand(1000), 0.5, 1000),
        'ties': (clustered(1000), torch.round(4 * rand(1000)) / 4, 0.5, 1000),
        'chain_2000': (chain, torch.linspace(1, 0, 2000, device=dev), 0.3, 2000),
        'identical_zero_area': (mixed, rand(1000), 0.5, 1000),
        'all_dead': (clustered(1000), torch.full((1000,), NMS.NEG_INF, device=dev), 0.5, 300),
        'all_alive_capped': (clustered(1000), rand(1000), 0.5, 50),
    }
    for n in (1, 63, 64, 65):
        cases[f'n_{n}'] = (clustered(n), rand(n), 0.5, n)
    return cases


def check_nms(gen) -> dict:
    """``greedy_nms`` against its plain version on the card (identical keep
    sets) at the main path's shapes, each through its entry point and as
    its callers batch it: ``rpn_proposals``' one ``batched_nms`` call over
    a train step's two images at the train canvas, and each image alone;
    ``multiclass_nms`` at OV-COCO width on one image and on a 32-image
    ``rescore`` batch, at OV-LVIS width on one and two images (shared and
    per-class boxes). Each entry's outputs are held to the same entry with
    the plain version on the card and, for one image or the RPN's two, on
    the CPU; and adversarial cases. Each main-path shape timed beside the
    plain version, with its plan, its bound and the kernel's cycles by
    part."""
    from oadp_torch.models import rpn as RPN
    from oadp_torch.ops import nms as NMS

    dev = torch.device('cuda')

    def equal(x, y) -> bool:  # a NaN box equal to itself
        x, y = x.cpu(), y.cpu()
        return torch.equal(x, y) or (x.shape == y.shape and x.dtype == y.dtype and bool(
            ((x == y) | (x.isnan() & y.isnan())).all()))

    def same(a, b) -> bool:
        return all(equal(x, y) for x, y in zip(a, b))

    def held(name, entry, args, timed_shape=True, cpu=True):
        """The entry point on the card against itself with the plain
        version on the card and (``cpu``) on the CPU, on the same inputs,
        and its kernel call against the plain version."""
        out, ((a, k),) = _captured_keep(lambda: entry(*args))
        keep_fn = NMS.greedy_keep_sorted
        NMS.greedy_keep_sorted = NMS.greedy_keep_sorted_plain
        try:
            plain_out = entry(*args)
        finally:
            NMS.greedy_keep_sorted = keep_fn
        if not same(out, plain_out) or cpu and not same(
                out, entry(*(t.cpu() if torch.is_tensor(t) else t for t in args))):
            raise AssertionError(f'greedy_nms {name}: the outputs differ')
        keep = NMS.greedy_keep_sorted(*a, **k)
        plain = NMS.greedy_keep_sorted_plain(*a, **k)
        if not torch.equal(keep, plain):
            raise AssertionError(f'greedy_nms {name}: keep sets differ in '
                                 f'{int((keep != plain).sum())} places')
        return _nms_row(name, a, k, keep, timed_shape)

    results = {}
    # the RPN's batched_nms call at the train canvas, one for both images,
    # as rpn_proposals makes it
    rpn_args = []
    rpn_nms = RPN.batched_nms
    RPN.batched_nms = lambda *a: rpn_args.append(a) or rpn_nms(*a)
    try:
        RPN.rpn_proposals(*_rpn_inputs(gen, dev), nms_pre=RPN_PRE, max_per_img=RPN_MAX,
                          iou_threshold=RPN_IOU)
    finally:
        RPN.batched_nms = rpn_nms
    (boxes, scores, ids, thr, max_out), = rpn_args
    results['rpn_train'] = held('rpn_train', NMS.batched_nms, rpn_args[0])
    for i in range(boxes.shape[0]):
        results[f'rpn_train_image_{i}'] = held(f'rpn_train_image_{i}', NMS.batched_nms,
                                               (boxes[i], scores[i], ids[i], thr, max_out))
    if min(results[k]['plan']['cluster'] for k in results) < 2:
        raise AssertionError(f'greedy_nms: the RPN\'s few problems not in clusters: {results}')
    for name, classes, per_class, images in (
            ('ov_coco', 65, False, 1), ('ov_coco_batch_32', 65, False, 32),
            ('ov_lvis', 1203, False, 1), ('ov_lvis_batch_2', 1203, False, 2),
            ('ov_lvis_per_class', 1203, True, 1), ('ov_lvis_per_class_batch_2', 1203, True, 2)):
        boxes, sc = (torch.stack(t) for t in zip(*(
            _det_inputs(gen, dev, classes, per_class) for _ in range(images))))
        if images == 1:
            boxes, sc = boxes[0], sc[0]
        # the CPU holds one OV-COCO image; the plain passes of 32 images,
        # or of OV-LVIS's 1203 x 1000 x 1000, take the CPU minutes
        results[name] = held(name, NMS.multiclass_nms, (boxes, sc, 0.0, 0.5, 300, classes),
                             cpu=name == 'ov_coco')
    adversarial = {}
    for name, args in _adversarial(gen, dev).items():
        row = held(name, NMS.nms, args, timed_shape=False)
        adversarial[name] = {k: row[k] for k in ('problems', 'candidates', 'kept', 'plan')}
    if adversarial['nan_box']['kept'] != 3:
        raise AssertionError(f'greedy_nms nan_box: {adversarial["nan_box"]["kept"]} kept, not 3')
    # NaN boxes with finite scores among OV-COCO's multiclass candidates, in
    # one image of a batch of three
    batch = [_det_inputs(gen, dev, 65, False) for _ in range(3)]
    rows = torch.arange(0, 1000, 11, device=dev)
    batch[1][0][rows, rows % 4] = float('nan')
    boxes, sc = (torch.stack(t) for t in zip(*batch))
    row = held('ov_coco_nan_boxes', NMS.multiclass_nms, (boxes, sc, 0.0, 0.5, 300, 65),
               timed_shape=False)
    adversarial['ov_coco_nan_boxes'] = {
        k: row[k] for k in ('problems', 'candidates', 'kept', 'plan')}
    results['adversarial'] = adversarial
    log(json.dumps({'nms_adversarial': adversarial}))
    return results


#: ``greedy_nms``'s clock cycles by part (csrc/nms.cu: thread 0 of a
#: problem's first block): (a) its tests against the kept list, (b) its
#: warp's column words, the barriers before (b) and (c) (waiting for the
#: other warps and blocks), (c) the decision, the appends and the block
#: barrier
NMS_PARTS = ('kept_tests', 'iou_words', 'barriers', 'decisions')


def _nms_row(name, a, k, keep, timed_shape) -> dict:
    """One kernel call's shape, plan and keep count and, for a main-path
    shape, its times (device, events), the plain version's, its bound and
    its cycles by part."""
    from oadp_torch.ops import nms as NMS

    boxes, alive, thr, max_keep = a
    order = k.get('order')
    p, n = alive.shape
    plan = NMS.nms_plan(p, n, torch.cuda.get_device_properties(alive.device).multi_processor_count)
    row = dict(name=f'greedy_nms({name})', problems=p, candidates=n, iou=thr, max_keep=max_keep,
               shared_boxes=order is not None, kept=int(keep.sum()), identical=True,
               max_abs_err=0.0, plan=dataclasses.asdict(plan))
    if not timed_shape:
        return row

    def kernel():
        return NMS.greedy_keep_sorted(*a, **k)

    def plain():
        return NMS.greedy_keep_sorted_plain(*a, **k)

    nbytes = boxes.numel() * 4 + (order.numel() * 8 if order is not None else 0) + 2 * p * n
    pairs = _needed_pairs(keep, alive, max_keep)
    t_bytes, t_ops = nbytes / PEAK_BYTES, IOU_FLOP * pairs / PEAK_FP32
    cycles = torch.zeros(p, 4, dtype=torch.int64, device=alive.device)
    NMS._greedy_nms(boxes, alive, thr, max_keep, order, cycles=cycles)
    parts = cycles.sum(0).tolist()
    row.update(
        kernel_device_ms=device_ms(kernel, 20), kernel_ms=timed(kernel, 20),
        plain_ms=timed(plain, 3), library_ms=None, bound_ms=1e3 * max(t_bytes, t_ops),
        bound_by='operations' if t_ops >= t_bytes else 'bytes', bytes=nbytes, iou_pairs=pairs,
        cycles_per_problem={part: c / p for part, c in zip(NMS_PARTS, parts)},
        cycle_share={part: c / max(1, sum(parts)) for part, c in zip(NMS_PARTS, parts)})
    log(json.dumps({'nms_check': row}))
    return row


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
    import os

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
    import os

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

    fwd_ms, fwd_bwd_ms = timed(roi_fwd, 5), timed(roi_fwd_bwd, 5)
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

    from oadp_torch.ops import attention as A
    from oadp_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.library()
    log(json.dumps({'build_s': time.perf_counter() - t0,
                    'library_dir': str(cuda_lib.build_dir())}))

    gen = torch.Generator(device='cuda').manual_seed(0)
    checks = check_kernels(A, gen)
    long_check = check_long_attention(A, gen)
    embed_checks = check_embed(gen)
    embedding = embed_checks.pop('embedding')
    checks.update(embed_checks)
    unfold = unfold_device_ms()
    checks['patch_rows']['library_device_ms'] = unfold[OBJ_BATCH]['device_ms']
    checks['patch_rows']['globals_batch']['library_device_ms'] = unfold[GLOB_BATCH]['device_ms']
    nms_check = check_nms(gen)
    plan_checks = check_plans(A, gen)
    # one directory for phases 4-7: phase 7 trains on phase 4's images and
    # OAKE records, from phase 6's checkpoint, with phase 5's prompts
    with tempfile.TemporaryDirectory(dir=pathlib.Path(__file__).resolve().parent / 'build') as tmp:
        tmp = pathlib.Path(tmp)
        for sub in ('oake', 'dp', 'train'):
            (tmp / sub).mkdir()
        path = main_path(card, tmp / 'oake')
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

    both = 'oadp_torch/csrc/ln_gemm.cu, oadp_torch/csrc/attention.cu'
    kernel_info = {  # TPU kernel replaced, sources, dispatches whose launches count
        'fused_surgery_layer': ('oadp_tpu/ops/attention.py:425', both, ['objects']),
        'fused_ln_mlp_rows': ('oadp_tpu/ops/attention.py:672',
                              'oadp_torch/csrc/ln_gemm.cu', ['objects']),
        'fused_ln_qkv_attention': ('oadp_tpu/ops/attention.py:218',
                                   'oadp_torch/csrc/ln_qkv_attention.cu',
                                   ['globals', 'blocks']),
        'fused_mha_qkv': ('oadp_tpu/ops/attention.py:105',
                          'oadp_torch/csrc/attention.cu', ['split']),
        'fused_side_attention': ('oadp_tpu/ops/attention.py:587',
                                 'oadp_torch/csrc/attention.cu', ['split']),
        'ln_mlp_residual': ('oadp_tpu/models/clip.py:289 _mlp (XLA, not a Pallas kernel)',
                            'oadp_torch/csrc/ln_gemm.cu', ['objects', 'globals', 'blocks']),
        'out_proj_residual': ('oadp_tpu/models/clip.py:318 _block_fused out-projection '
                              '(XLA, not a Pallas kernel)', 'oadp_torch/csrc/ln_gemm.cu',
                              ['globals', 'blocks']),
        'resize_crops': ('oadp_tpu/oake/encoders.py:401-432 prep_one + normalize_clip '
                         '(ops/preprocess.py:304, 410, 511, 542; XLA, not a Pallas kernel)',
                         'oadp_torch/csrc/preprocess.cu', ['objects', 'globals', 'split']),
        'patch_rows': ('oadp_tpu/models/clip.py:350 conv (its im2col rows; XLA, not a Pallas '
                       'kernel)', 'oadp_torch/csrc/embed.cu',
                       ['objects', 'globals', 'blocks', 'split']),
        'patch_embed': ('oadp_tpu/models/clip.py:350 conv (its product; XLA, not a Pallas '
                        'kernel)', 'oadp_torch/csrc/ln_gemm.cu',
                        ['objects', 'globals', 'blocks', 'split']),
        'embed_ln_pre': ('oadp_tpu/models/clip.py:358-364 CLS + positional embedding, :423 '
                         'ln_pre (XLA, not a Pallas kernel)', 'oadp_torch/csrc/embed.cu',
                         ['objects', 'globals', 'blocks', 'split']),
    }
    kernels = []
    for name, res in checks.items():
        replaces, source, paths = kernel_info[name]
        launches = path['launches'][name]
        entry = dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=launches,
            launches_per_dispatch=launches / sum(path['dispatches'][d] for d in paths),
            max_abs_err=res['max_abs_err'], cosine=res['cosine'],
            ms=res['kernel_ms'], plain_ms=res['plain_ms'], bound_ms=res['bound_ms'],
            bound_by=res['bound_by'], library_ms=res['library_ms'],
            device_ms=res['kernel_device_ms'], library_device_ms=res['library_device_ms'],
        )
        if 'kernel_device_ms_by_part' in res:
            entry['device_ms_by_part'] = res['kernel_device_ms_by_part']
        for key in ('residual_delta_cosine', 'large_mean_bf16_excess', 'plans',
                    'taps_identical', 'pixels_one_step_off', 'pixels', 'identical'):
            if key in res:
                entry[key] = res[key]
        if name == 'patch_embed':  # the whole embedding before layer 0, the three kernels
            entry['embedding'] = embedding
        # every ln_gemm plan on the launches of this entry (check_plans)
        entry.update({'every_plan' + launch[len(name):]: plan_checks[launch]
                      for launch in plan_checks if launch.split(' ')[0].split('(')[0] == name})
        for shape in ('side_only', 'blocks_batch', 'globals_batch', 'objects_batch'):
            if shape in res:
                entry[shape] = {k: res[shape][k] for k in (
                    'name', 'kernel_ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                    'kernel_device_ms', 'library_device_ms', 'max_abs_err', 'cosine',
                    'residual_delta_cosine', 'large_mean_bf16_excess',
                    'kernel_device_ms_by_part', 'plans', 'pixels_one_step_off',
                    'pixels') if k in res[shape]}
        kernels.append(entry)
    nms_launches = {'dp': dp['launches']['greedy_nms'],
                    'dp_train': train['launches']['greedy_nms'],
                    'calibration': calibration['launches']['greedy_nms']}
    rpn = nms_check['rpn_train']
    kernels.append(dict(
        name='greedy_nms', route='cuda', source='oadp_torch/csrc/nms.cu',
        replaces='oadp_tpu/ops/nms.py:38 / :187 (lax.while_loop NMS, not a Pallas kernel)',
        launches=sum(nms_launches.values()), launches_by_phase=nms_launches,
        max_abs_err=0.0, ms=rpn['kernel_ms'], plain_ms=rpn['plain_ms'], bound_ms=rpn['bound_ms'],
        bound_by=rpn['bound_by'], library_ms=None, device_ms=rpn['kernel_device_ms'],
        library_device_ms=None, shape=rpn['name'],
        plan=rpn['plan'], cycle_share=rpn['cycle_share'],
        **{name: {k: nms_check[name][k] for k in (
            'name', 'problems', 'candidates', 'kept', 'plan', 'kernel_ms', 'kernel_device_ms',
            'plain_ms', 'bound_ms', 'bound_by', 'cycle_share')}
           for name in ('rpn_train_image_0', 'rpn_train_image_1', 'ov_coco', 'ov_coco_batch_32',
                        'ov_lvis', 'ov_lvis_batch_2', 'ov_lvis_per_class',
                        'ov_lvis_per_class_batch_2')}))
    kernels.append(dict(
        name='long_attention', route='cuda', source='oadp_torch/csrc/long_attention.cu',
        replaces='oadp_tpu/ops/attention.py:425 (_surgery_layer_kernel\'s attention, past '
                 '256 tokens: CLIP ViT-L/14 under OADP\'s surgery)',
        launches=None, max_abs_err=long_check['max_abs_err'], cosine=long_check['cosine'],
        ms=long_check['kernel_ms'], plain_ms=None, bound_ms=long_check['bound_ms'],
        bound_by=long_check['bound_by'], library_ms=long_check['library_ms'],
        device_ms=long_check['kernel_device_ms'],
        library_device_ms=long_check['library_device_ms'], shape=long_check['name']))
    log(f'card: {card}')
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
