"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

1. card: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: the CUDA kernels of ``oadp_torch/csrc`` (nvcc, sm_90a), timed;
3. kernels: each ported kernel at the main path's shapes against its plain
   PyTorch version on the card in bf16 (cosine >= 0.999), timed beside
   its plain version, a PyTorch library yardstick and its bound;
4. main path: the OAKE objects and globals CLIs (``oadp_torch.oake``) at
   full ViT-B/32 width (random weights from seed 0, bf16) on synthetic
   images with 1000 proposals each; checks every record, that the launch
   counters show every kernel on the path, and that 8 crops re-encoded on
   the CPU in fp32 agree with the card (cosine >= 0.99); images/s.

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
    lib_w = {k: v.t().contiguous() for k, v in dict(
        qkv=qkv_w, out=out_w, fc=fc_w, proj=proj_w).items()}
    w_bytes = 2 * (qkv_w.numel() + qkv_b.numel() + 2 * D)
    results = {}

    def record(name, kernel, plain, library, flops, nbytes, iters, **extra):
        got, want = kernel(), plain()
        err, cos = compare(got, want)
        del got, want
        if cos < 0.999:
            raise AssertionError(f'{name}: cosine {cos} < 0.999 against the plain version')
        b_ms, b_by = bound_ms(flops, nbytes)
        res = dict(
            name=name, max_abs_err=err, cosine=cos,
            kernel_ms=timed(kernel, iters), plain_ms=timed(plain, max(2, iters // 4)),
            library_ms=timed(library, iters), bound_ms=b_ms, bound_by=b_by,
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
    k1 = record(
        'fused_surgery_layer',
        lambda: A.fused_surgery_layer(*args, **fold),
        lambda: A.fused_surgery_layer_plain(*args, **fold),
        lambda: lib_k1(True),
        flops=2 * b * (n + 1) * D * 3 * D + 4 * b * HEADS * n * n * HD
        + 4 * b * HEADS * n * HD + 2 * b * (n + 1) * D * D,
        nbytes=2 * act_bytes - 4 * bias.numel() + w_bytes + 2 * (D * D + D),
        iters=5,
    )
    k1_side = record(
        'fused_surgery_layer(with_main=False)',
        lambda: A.fused_surgery_layer(*args, with_main=False),
        lambda: A.fused_surgery_layer_plain(*args, with_main=False),
        lambda: lib_k1(False),
        flops=2 * b * n * D * 2 * D + 2 * b * D * 3 * D + 4 * b * HEADS * n * HD,
        nbytes=act_bytes + 2 * y.numel() + w_bytes,
        iters=5,
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
        lambda: A.fused_ln_mlp_rows(*mlp),
        lambda: A.fused_ln_mlp_rows_plain(*mlp),
        lib_k2,
        flops=4 * OBJ_BATCH * D * 4 * D,
        nbytes=2 * (2 * yy.numel() + fc_w.numel() + proj_w.numel() + 6 * D),
        iters=50,
    )

    # kernel 3: every layer of the stock encoder at the globals batch
    b3, n3 = GLOB_BATCH, N_GLOB
    x3 = r(b3, n3, D)
    a3 = (x3, ln_s, ln_b, qkv_w, qkv_b, HEADS, HD ** -0.5)

    def lib_k3():
        hx = F.layer_norm(x3, (D,), ln_s, ln_b)
        q, k, v = (_split(t, b3, n3) for t in F.linear(hx, lib_w['qkv'], qkv_b).split(D, -1))
        return _merge(F.scaled_dot_product_attention(q, k, v))

    k3 = record(
        'fused_ln_qkv_attention',
        lambda: A.fused_ln_qkv_attention(*a3),
        lambda: A.fused_ln_qkv_attention_plain(*a3),
        lib_k3,
        flops=2 * b3 * n3 * D * 3 * D + 4 * b3 * HEADS * n3 * n3 * HD,
        nbytes=2 * 2 * x3.numel() + w_bytes,
        iters=50,
    )
    results.update({
        'fused_surgery_layer': dict(k1, side_only=k1_side),
        'fused_ln_mlp_rows': k2,
        'fused_ln_qkv_attention': k3,
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


def main_path(A, card: str) -> dict:
    from oadp_torch.oake import encoders as E
    from oadp_torch.oake import globals as G
    from oadp_torch.oake import objects as O
    from oadp_torch.utils import load_pth

    repo = pathlib.Path(__file__).resolve().parent
    calls = dict(objects=0, globals=0)
    packed, glob = E.OakeSteps.objects_packed_step, E.OakeSteps.globals_step

    def count_packed(self, *a, **k):
        calls['objects'] += 1
        return packed(self, *a, **k)

    def count_globals(self, *a, **k):
        calls['globals'] += 1
        return glob(self, *a, **k)

    E.OakeSteps.objects_packed_step = count_packed
    E.OakeSteps.globals_step = count_globals
    with tempfile.TemporaryDirectory(dir=repo / 'build') as tmp:
        root = pathlib.Path(tmp)
        data = make_data(root)
        obj_cfg = write_config(str(repo / 'configs/oake/objects_coco.py'), root, data,
                               str(root / 'objects'))
        glob_cfg = write_config(str(repo / 'configs/oake/globals.py'), root, data,
                                str(root / 'globals'))
        override = ['--override', ".model.device:'cuda'", ".model.dtype:'bfloat16'"]

        A.reset_launches()
        objects = O.main(['smoke_objects', str(obj_cfg), *override])
        globals_ = G.main(['smoke_globals', str(glob_cfg), *override])
        torch.cuda.synchronize()
        launches, dispatches = dict(A.LAUNCHES), dict(calls)
        log(json.dumps({'main_path_launches': launches, 'dispatches': dispatches}))

        expect = {
            'fused_surgery_layer': 12 * dispatches['objects'],
            'fused_ln_mlp_rows': 12 * dispatches['objects'],
            'fused_ln_qkv_attention': 12 * dispatches['globals'],
        }
        if launches != expect or not all(launches.values()):
            raise AssertionError(f'launch counts {launches} != expected {expect}')
        cfg = objects.model.config
        if (cfg.width, cfg.layers, cfg.heads, objects.model.surgery_config.tokens) != (
                768, 12, 12, 197):
            raise AssertionError(f'not the full ViT-B/32: {cfg}')

        for i, id_ in enumerate(data['ids']):
            rec = load_pth(root / 'objects' / f'{id_:012d}.pth')
            raw = data['raw'][i]
            emb = rec['embeddings']
            if emb.shape != (len(raw), 512) or emb.dtype != np.float16:
                raise AssertionError(f'objects {id_}: {emb.shape} {emb.dtype}')
            norms = np.linalg.norm(emb.astype(np.float32), axis=-1)
            if not np.isfinite(emb).all() or np.abs(norms - 1).max() > 1e-2:
                raise AssertionError(f'objects {id_}: not finite unit rows')
            np.testing.assert_array_equal(rec['bboxes'], raw[:, :4].astype(np.float16))
            np.testing.assert_array_equal(rec['objectness'], raw[:, 4:].astype(np.float16))
            g = load_pth(root / 'globals' / f'{id_:012d}.pth')
            if g.shape != (512,) or g.dtype != np.float16 or not np.isfinite(g).all():
                raise AssertionError(f'globals {id_}: {g.shape} {g.dtype}')
            if abs(float(np.linalg.norm(g.astype(np.float32))) - 1) > 1e-2:
                raise AssertionError(f'globals {id_}: not unit norm')

        # 8 crops of the first image re-encoded on the CPU in fp32
        cpu_model = E.load_clip(
            objects.config.model.checkpoint, 'float32', device='cpu'
        )
        item = dict(id=data['ids'][0], output=None, proposals=dict(
            (id_, p) for id_, p in zip(data['ids'], data['raw'])))
        item['image'] = objects._dataset.load(item['id'])
        item['height'], item['width'] = item['image'].shape[:2]
        prep = objects.prepare(item)
        buf, rows, _ = prep['chunks'][0]
        steps = E.OakeSteps(cpu_model, objects.pad, objects.pad)
        n_img = objects.pad * objects.pad * 3
        grid = cpu_model.grid
        image = buf[:n_img].reshape(objects.pad, objects.pad, 3)
        masks = buf[n_img:n_img + rows * grid * grid].reshape(rows, grid, grid)[:8]
        meta = buf[n_img + rows * grid * grid:].view(np.float32).reshape(rows, 9)[:8]
        emb_cpu = steps.objects_step(image, meta, masks, prep['k']).float().numpy()
        emb_card = load_pth(root / 'objects' / f'{item["id"]:012d}.pth')['embeddings'][:8]
        cos = float((emb_cpu * emb_card.astype(np.float32)).sum(-1).min())
        log(json.dumps({'cpu_fp32_vs_card_bf16_min_cosine': cos}))
        if cos < 0.99:
            raise AssertionError(f'CPU fp32 re-encode cosine {cos} < 0.99')

        # steady-state rate: the same pipelines again into fresh directories
        rates = {}
        for name, pipe in (('objects', objects), ('globals', globals_)):
            pipe.config.val.dataloader.dataset.output_dir = str(root / f'{name}_timed')
            t0 = time.perf_counter()
            pipe.run()
            torch.cuda.synchronize()
            rates[name] = N_IMAGES / (time.perf_counter() - t0)
    E.OakeSteps.objects_packed_step, E.OakeSteps.globals_step = packed, glob
    res = dict(images=N_IMAGES, proposals_per_image=N_PROPOSALS,
               objects_img_s=rates['objects'], globals_img_s=rates['globals'],
               cpu_fp32_min_cosine=cos, card=card, launches=launches,
               dispatches=dispatches)
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

    sources = 'oadp_torch/csrc/ln_gemm.cu, oadp_torch/csrc/attention.cu'
    replaces = {
        'fused_surgery_layer': 'oadp_tpu/ops/attention.py:425',
        'fused_ln_mlp_rows': 'oadp_tpu/ops/attention.py:672',
        'fused_ln_qkv_attention': 'oadp_tpu/ops/attention.py:218',
    }
    per_dispatch = {
        'fused_surgery_layer': path['dispatches']['objects'],
        'fused_ln_mlp_rows': path['dispatches']['objects'],
        'fused_ln_qkv_attention': path['dispatches']['globals'],
    }
    kernels = []
    for name, res in checks.items():
        entry = dict(
            name=name, route='cuda', source=sources, replaces=replaces[name],
            launches=path['launches'][name],
            launches_per_dispatch=path['launches'][name] / per_dispatch[name],
            max_abs_err=res['max_abs_err'], cosine=res['cosine'],
            ms=res['kernel_ms'], plain_ms=res['plain_ms'], bound_ms=res['bound_ms'],
            bound_by=res['bound_by'], library_ms=res['library_ms'],
        )
        if 'side_only' in res:
            entry['side_only'] = {k: res['side_only'][k] for k in (
                'kernel_ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                'max_abs_err', 'cosine')}
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
