"""Time the port's CUDA kernels and one objects dispatch on the GPU.

    python -m oadp_torch.profile_kernels

Prints JSON lines, each with the card's name and power limit:

* ``gemm``: the ``ln_gemm`` product alone at the objects QKV shape
  (2048 x 197 rows, 768 -> 2304), with and without the LN pass, beside
  ``torch.mm`` (cuBLAS) on the same operands;
* ``patch_embed``: the surgery encoder's patch embedding at 2048 crops,
  the block product of ``models/clip.py`` beside ``F.conv2d``;
* ``attention``: the ``attention`` kernel at 2048 crops x 12 heads x 197
  tokens (main rows, side row, both) beside
  ``F.scaled_dot_product_attention`` on the main rows;
* ``dispatch``: one objects dispatch (2 images x 1024 crops, full
  ViT-B/32, bf16, random weights from seed 0): its wall time and the
  CUDA time by kernel from ``torch.profiler``.

Needs one CUDA device; exits nonzero without one.
"""

import json
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


def main() -> int:
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
    x = torch.randn(m, d, device=dev, generator=gen).bfloat16()
    w = (torch.randn(d, 3 * d, device=dev, generator=gen) * d ** -0.5).bfloat16()
    wb = torch.zeros(3 * d, device=dev).bfloat16()
    ln = (torch.ones(d, device=dev).bfloat16(), torch.zeros(d, device=dev).bfloat16())
    qkv = torch.empty(m, 3 * d, device=dev).bfloat16()
    flops = 2 * m * d * 3 * d
    gemm = {
        'ln_gemm_ms': _timed(lambda: A._ln_gemm(x, w, wb, qkv)),
        'ln_gemm_with_ln_ms': _timed(lambda: A._ln_gemm(x, w, wb, qkv, ln=ln)),
        'torch_mm_ms': _timed(lambda: torch.mm(x, w)),
    }
    emit('gemm', shape=[m, d, 3 * d], **gemm,
         ln_gemm_tflops=flops / gemm['ln_gemm_ms'] / 1e9,
         torch_mm_tflops=flops / gemm['torch_mm_ms'] / 1e9)
    del x

    qkv_y = torch.randn(b, 3 * d, device=dev, generator=gen).bfloat16()
    bias = torch.zeros(b, n, device=dev)
    main = torch.empty(b, n, d, device=dev).bfloat16()
    side = torch.empty(b, d, device=dev).bfloat16()
    args = (qkv, b, n, heads, 3 * d, (0, d, 2 * d), 0.125)
    q, k, v = (t.reshape(b, n, heads, 64).transpose(1, 2).contiguous()
               for t in qkv.view(b, n, 3 * d).split(d, -1))
    emit('attention', crops=b, heads=heads, tokens=n,
         main_and_side_ms=_timed(lambda: A._attention(
             *args, out=main, qkv_y=qkv_y, bias=bias, side=side)),
         main_ms=_timed(lambda: A._attention(*args, out=main)),
         side_ms=_timed(lambda: A._attention(
             *args, qkv_y=qkv_y, bias=bias, side=side)),
         sdpa_main_ms=_timed(lambda: F.scaled_dot_product_attention(q, k, v)))
    del qkv, q, k, v, main
    torch.cuda.empty_cache()

    model = E.load_clip(None, 'bfloat16', device=dev)
    crops = torch.randn(b, 224, 224, 3, device=dev, generator=gen).bfloat16()
    cfg, params = model.surgery_config, model.surgery_params
    emit('patch_embed', crops=b, stride=cfg.stride, patch=cfg.patch_size,
         block_product_ms=_timed(lambda: C._embed_patches(crops, params, cfg)),
         conv2d_ms=_timed(lambda: F.conv2d(
             crops.permute(0, 3, 1, 2), params['conv1'], stride=cfg.stride,
             padding=(cfg.patch_size - 1) // 2)))
    del crops
    steps = E.OakeSteps(model, 640, 640)
    bufs = _dispatch_inputs(model)
    k_pad = 21
    for _ in range(2):
        steps.objects_packed_step(bufs, 1024, k_pad)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        steps.objects_packed_step(bufs, 1024, k_pad)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps.objects_packed_step(bufs, 1024, k_pad)
        torch.cuda.synchronize()
    # kernels only: an operator's row repeats the time of the kernels it ran
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in events) / 1e3
    emit('dispatch', crops=2048, wall_ms=wall_ms, cuda_ms=total, top=[
        dict(name=e.key[:80], ms=e.self_device_time_total / 1e3, calls=e.count)
        for e in events[:20]
    ])
    return 0


if __name__ == '__main__':
    sys.exit(main())
