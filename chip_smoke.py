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
   and at 2048. Each kernel gets its K-major weights and fp32 LayerNorm
   parameters prepared once, as the encoders hold them, and the library
   yardstick its transposed weights once. Two times per call for the
   kernel and for the yardstick: CUDA events around back-to-back calls
   (host launch overhead included) and the device time from
   ``torch.profiler`` (the sum of the call's kernel durations; for
   kernel 1 also by part: LN pass, QKV product, attention,
   out-projection; for kernel 3: LN pass, fused QKV product and
   attention). Kernels 1 and 3 are also held to their plain versions on
   rows with a large per-row mean and outlier columns, as CLIP residual
   streams carry;
4. main path, each part with the launch counts set to 0 just before it
   and checked just after: the OAKE objects, globals and blocks CLIs
   (``oadp_torch.oake``) at full ViT-B/32 width (random weights from seed
   0, bf16) on synthetic images with 1000 proposals each, every record
   checked; the surgery encoder's split wiring (``objects_step`` on 999
   crops: kernels 4 and 5 only) against its fused wiring on the same
   crops (cosine >= 0.99) and timed beside it; CPU fp32 re-encodes of
   crops, a whole image (globals) and blocks against the card (cosine
   >= 0.99); images/s of a warm second run of each CLI.

The last two lines are the ``kernels`` JSON line and the result line
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import json
import pathlib
import pickle
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    if total_us <= 0:
        raise AssertionError('torch.profiler recorded no device time')
    if part_of is None:
        return total_us / iters / 1e3
    split = {}
    for e in events:
        part = part_of(e.key)
        split[part] = split.get(part, 0.0) + e.self_device_time_total / iters / 1e3
    return total_us / iters / 1e3, split


def _part(name: str) -> str:
    """The part of kernel 1 or 3 a kernel belongs to, by its (mangled or
    demangled) name: the LN pass, kernel 3's fused QKV product and
    attention, the QKV product, attention, the out-projection (the product
    with the residual epilogue, template argument 2)."""
    if 'ln_qkv_attention_kernel' in name:
        return 'qkv_attention'
    if 'layer_norm' in name:
        return 'ln'
    if 'attention_kernel' in name:
        return 'attention'
    if 'gemm_kernel' in name:
        return 'out_projection' if ('ELi2E' in name or ', 2>' in name) else 'qkv'
    return 'other'


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def _split(t, b, n):
    return t.reshape(b, n, HEADS, HD).transpose(1, 2)


def _merge(t):
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd)


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

    def record(name, kernel, plain, library, flops, nbytes, iters, part_of=None, **extra):
        got, want = kernel(), plain()
        err, cos = compare(got, want)
        del got, want
        if cos < 0.999:
            raise AssertionError(f'{name}: cosine {cos} < 0.999 against the plain version')
        b_ms, b_by = bound_ms(flops, nbytes)
        dev = device_ms(kernel, iters, part_of)
        if part_of is not None:
            dev, extra['kernel_device_ms_by_part'] = dev
        res = dict(
            name=name, max_abs_err=err, cosine=cos,
            kernel_ms=timed(kernel, iters), plain_ms=timed(plain, max(2, iters // 4)),
            library_ms=timed(library, iters), bound_ms=b_ms, bound_by=b_by,
            kernel_device_ms=dev,
            library_device_ms=device_ms(library, iters),
            **extra,
        )
        log(json.dumps({'kernel_check': res}))
        torch.cuda.empty_cache()
        return res

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
    lm_err, lm_cos = compare(
        A.fused_surgery_layer(*lm_args, **fold, **prep, out_wt=lib_w['out']),
        A.fused_surgery_layer_plain(*lm_args, **fold))
    if lm_cos < 0.999:
        raise AssertionError(f'fused_surgery_layer: cosine {lm_cos} < 0.999 on large-mean rows')
    del lm_args
    k1 = record(
        'fused_surgery_layer',
        lambda: A.fused_surgery_layer(*args, **fold, **prep, out_wt=lib_w['out']),
        lambda: A.fused_surgery_layer_plain(*args, **fold),
        lambda: lib_k1(True),
        flops=2 * b * (n + 1) * D * 3 * D + 4 * b * HEADS * n * n * HD
        + 4 * b * HEADS * n * HD + 2 * b * (n + 1) * D * D,
        nbytes=2 * act_bytes - 4 * bias.numel() + w_bytes + 2 * (D * D + D),
        iters=5, part_of=_part, large_mean_max_abs_err=lm_err, large_mean_cosine=lm_cos,
    )
    k1_side = record(
        'fused_surgery_layer(with_main=False)',
        lambda: A.fused_surgery_layer(*args, with_main=False, **prep),
        lambda: A.fused_surgery_layer_plain(*args, with_main=False),
        lambda: lib_k1(False),
        flops=2 * b * n * D * 2 * D + 2 * b * D * 3 * D + 4 * b * HEADS * n * HD,
        nbytes=act_bytes + 2 * y.numel() + w_bytes,
        iters=5, part_of=_part,
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
            iters=50 if b3 == GLOB_BATCH else 10, part_of=_part,
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
    })
    return results


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


def main_path(A, card: str) -> dict:
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
        A.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = dict(A.LAUNCHES)
        want = {k: expect().get(k, 0) for k in launches}
        log(json.dumps({'launches': {label: launches}, 'dispatches': dict(calls)}))
        if launches != want or not all(expect().values()):
            raise AssertionError(f'{label}: launch counts {launches} != expected {want}')
        return out, launches

    with tempfile.TemporaryDirectory(dir=repo / 'build') as tmp:
        root = pathlib.Path(tmp)
        data = make_data(root)
        cfgs = {name: write_config(str(repo / f'configs/oake/{base}.py'), root, data,
                                   str(root / name))
                for name, base in (('objects', 'objects_coco'), ('globals', 'globals'),
                                   ('blocks', 'blocks'))}
        override = ['--override', ".model.device:'cuda'", ".model.dtype:'bfloat16'"]

        objects, l_obj = driven('objects', lambda: O.main(
            ['smoke_objects', str(cfgs['objects']), *override]), lambda: {
                'fused_surgery_layer': 12 * calls['objects'],
                'fused_ln_mlp_rows': 12 * calls['objects']})
        globals_, l_glob = driven('globals', lambda: G.main(
            ['smoke_globals', str(cfgs['globals']), *override]), lambda: {
                'fused_ln_qkv_attention': 12 * calls['globals']})
        blocks, l_blocks = driven('blocks', lambda: BL.main(
            ['smoke_blocks', str(cfgs['blocks']), *override]), lambda: {
                'fused_ln_qkv_attention': 12 * calls['blocks']})
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
                'fused_mha_qkv': 11, 'fused_side_attention': 12})
        fused, _ = driven('fused', lambda: card_steps.objects_step(
            image, meta[:nb + 1], masks[:nb + 1], k_pad).float().cpu().numpy(), lambda: {
                'fused_surgery_layer': 12, 'fused_ln_mlp_rows': 12})
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
    path = main_path(A, card)

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
        for shape in ('side_only', 'blocks_batch', 'objects_batch'):
            if shape in res:
                entry[shape] = {k: res[shape][k] for k in (
                    'name', 'kernel_ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                    'kernel_device_ms', 'library_device_ms', 'max_abs_err', 'cosine',
                    'kernel_device_ms_by_part') if k in res[shape]}
        kernels.append(entry)
    log(f'card: {card}')
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
