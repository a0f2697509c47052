"""Time the port's CUDA kernels and one objects dispatch on the GPU.

    python -m oadp_torch.profile_kernels [--only gemm,attention,...]

Prints JSON lines, each with the card's name and power limit (``--only``
keeps the named parts, default all):

* ``gemm``: the ``ln_gemm`` product alone at the objects QKV shape
  (2048 x 197 rows, 768 -> 2304), with and without the LN pass, beside
  ``torch.mm`` (cuBLAS) on the same operands; and at kernel 2's two
  products (2048 rows, 768 -> 3072 and 3072 -> 768), each at every tile
  width (``tile_n`` 256, 128, 64) beside the width the kernel picks; and
  (``gemm_residual``) kernel 1's out-projection with its residual (2048 x
  197 rows, 768 -> 768, x + main @ W + b) at every width beside
  ``torch.addmm`` plus the add, with its bound;
* ``ln_qkv``: kernel 3 (``fused_ln_qkv_attention``) at the globals (16)
  and blocks (728) batches of 50 tokens, by kernel (device time from
  ``torch.profiler``), beside the two families' route (the LN pass,
  ``ln_gemm``, ``attention``) and the library calls (``F.layer_norm``,
  ``F.linear``, SDPA) on the same inputs;
* ``patch_embed``: the surgery encoder's patch embedding at 2048 crops,
  the block product of ``models/clip.py`` beside ``F.conv2d``;
* ``attention``: the ``attention`` kernel at 2048 crops x 12 heads x 197
  tokens (main rows, side row, both) beside
  ``F.scaled_dot_product_attention`` on the main rows;
* ``dispatch``: one objects dispatch (2 images x 1024 crops, full
  ViT-B/32, bf16, random weights from seed 0): its wall time and the
  CUDA time by kernel from ``torch.profiler``;
* ``split_dispatch`` and ``fused_dispatch``: ``objects_step`` on 999
  crops of one image (the surgery encoder's split wiring, kernels 4 and
  5) and on the first 1000 of the same crops (the fused wiring, kernels 1
  and 2), each broken down the same way;
* ``globals_dispatch`` and ``blocks_dispatch``: the stock encoder's
  dispatches (kernel 3), one ``globals_step`` of 16 640x480 images and
  one ``blocks_step`` of 24 (``configs/oake/blocks.py``'s batch): 24
  wholes and their 624 blocks padded to 704, the 728-crop blocks batch of
  ``chip_smoke.py``, broken down the same way;
* ``text``: one batch of the ViLD prompt builder (256 rows of 77
  tokens) through the full CLIP text tower (width 512, 12 layers, 8
  heads, fp32 products without TF32, random weights from seed 0), broken
  down the same way, beside its operation count and the time it takes
  at the card's fp32 peak outside the tensor cores.

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


def _breakdown(step) -> dict:
    """Wall time of ``step`` (host clock, synchronised, after two warm
    calls) and the CUDA time by kernel of one more call from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # kernels only: an operator's row repeats the time of the kernels it ran
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    return dict(wall_ms=wall_ms,
                cuda_ms=sum(e.self_device_time_total for e in events) / 1e3,
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


def main(argv=None) -> int:
    import argparse

    parts = ('gemm', 'attention', 'ln_qkv', 'patch_embed', 'dispatch', 'globals_dispatch',
             'blocks_dispatch', 'text')
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
        ln = A.ln_fp32(torch.ones(d, device=dev), torch.zeros(d, device=dev))
        for rows, k_in, n_out, iters in ((m, d, 3 * d, 10), (b, d, 4 * d, 200),
                                         (b, 4 * d, d, 200)):
            x = torch.randn(rows, k_in, device=dev, generator=gen).bfloat16()
            w = (torch.randn(k_in, n_out, device=dev, generator=gen) * k_in ** -0.5).bfloat16()
            wt, wb = A.kmajor(w), torch.zeros(n_out, device=dev).bfloat16()
            out = torch.empty(rows, n_out, device=dev).bfloat16()
            flops = 2 * rows * k_in * n_out
            gemm = {f'ln_gemm_tile{t or "_auto"}_ms': _timed(
                lambda t=t: A._ln_gemm(x, wt, wb, out, tile_n=t), iters)
                for t in (0, 256, 128, 64)}
            gemm['torch_mm_ms'] = _timed(lambda: torch.mm(x, w), iters)
            if k_in <= 1024:
                gemm['ln_gemm_with_ln_ms'] = _timed(
                    lambda: A._ln_gemm(x, wt, wb, out, ln32=ln), iters)
            emit('gemm', shape=[rows, k_in, n_out], **gemm,
                 **{k.replace('_ms', '_tflops'): flops / v / 1e9 for k, v in gemm.items()
                    if 'with_ln' not in k})
            del x, out
        # kernel 1's out-projection with its residual (x_out = x + main @ W
        # + b): bound by its bytes as much as by its products
        main = torch.randn(m, d, device=dev, generator=gen).bfloat16()
        res = torch.randn(m, d, device=dev, generator=gen).bfloat16()
        w = (torch.randn(d, d, device=dev, generator=gen) * d ** -0.5).bfloat16()
        wt, wb = A.kmajor(w), torch.zeros(d, device=dev).bfloat16()
        out = torch.empty(m, d, device=dev).bfloat16()
        res_gemm = {f'ln_gemm_tile{t or "_auto"}_ms': _timed(
            lambda t=t: A._ln_gemm(main, wt, wb, out, epilogue=A._EPI_RESIDUAL, residual=res,
                                   tile_n=t)) for t in (0, 256, 128, 64)}
        res_gemm['torch_addmm_add_ms'] = _timed(lambda: torch.addmm(wb, main, w).add_(res))
        emit('gemm_residual', shape=[m, d, d], **res_gemm,
             bound_ms=1e3 * max(2 * m * d * d / 989e12, 2 * 3 * m * d / 3.35e12),
             **{k.replace('_ms', '_tflops'): 2 * m * d * d / v / 1e9
                for k, v in res_gemm.items()})
        del main, res, out

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
        emit('patch_embed', crops=b, stride=cfg.stride, patch=cfg.patch_size,
             block_product_ms=_timed(lambda: C._embed_patches(crops, params, cfg)),
             conv2d_ms=_timed(lambda: F.conv2d(
                 crops.permute(0, 3, 1, 2), params['conv1'], stride=cfg.stride,
                 padding=(cfg.patch_size - 1) // 2)))
        del crops
    if 'dispatch' in only:
        steps = E.OakeSteps(model, 640, 640)
        bufs = _dispatch_inputs(model)
        k_pad = 21
        emit('dispatch', crops=2048,
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
