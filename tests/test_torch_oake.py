"""The port's OAKE objects, globals and blocks CLIs (``oadp_torch.oake``) against
``oadp_tpu.oake`` end to end, on ``tests/synthetic_data.py`` data and one
shared saved checkpoint, fp32 on the CPU: the same file set, records
that agree, equal boxes; plus resume, ``DRY_RUN`` and the refusal to run
on the CPU unless asked."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

VIT = dict(width=64, layers=2, heads=2, output_dim=32)
PAD = 320
CPU = ".model.device:'cpu'"


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    from tests.oracles import clip_torch
    from tests.synthetic_data import make_synthetic_coco

    root = tmp_path_factory.mktemp('oake_port')
    data = make_synthetic_coco(root, n_images=4, n_proposals=12)
    torch.manual_seed(7)
    visual = clip_torch.VisionTransformer(
        input_resolution=224, patch_size=32, output_dim=VIT['output_dim'],
        width=VIT['width'], layers=VIT['layers'], heads=VIT['heads'],
    ).eval()
    ckpt = root / 'clip.pt'
    torch.save(clip_torch.state_dict_openai_style(visual, numpy=False), ckpt)
    cfg = root / 'cfg.py'
    cfg.write_text(f"""
val = dict(
    dataloader=dict(
        dataset=dict(
            root={str(root / 'coco' / 'val2017')!r},
            annFile={data['ann_file']!r},
            output_dir={str(root / 'out')!r},
            proposal_file={data['proposal_file']!r},
            proposal_sorted=True,
        ),
    ),
)
model = dict(
    checkpoint={str(ckpt)!r},
    dtype='float32',
    max_image_size={PAD},
    vit={VIT!r},
)
log = dict(interval=10)
batch_size = 4
mini_batch_size = 16
""")
    setup = dict(root=root, data=data, cfg=cfg)
    for pkg in ('oadp_tpu', 'oadp_torch'):
        for task in ('objects', 'globals', 'blocks'):
            _run(setup, pkg, task, f'{pkg}_{task}')
    return setup


def _run(setup, pkg, task, out_sub, *extra):
    import importlib
    mod = importlib.import_module(f'{pkg}.oake.{task}')
    out = setup['root'] / 'out' / out_sub
    overrides = [f'.val.dataloader.dataset.output_dir:{str(out)!r}', *extra]
    if pkg == 'oadp_torch' and not any('device' in o for o in extra):
        overrides.append(CPU)
    mod.main([f'test_{task}', str(setup['cfg']), '--override', *overrides])
    return out


def _files(path):
    return sorted(p.name for p in path.glob('*.pth'))


def _cos(a, b):
    a = np.asarray(a, np.float64).reshape(-1, a.shape[-1])
    b = np.asarray(b, np.float64).reshape(-1, b.shape[-1])
    return float(((a * b).sum(-1) / (
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    )).min())


@pytest.mark.parametrize('task', ['objects', 'globals', 'blocks'])
def test_records_agree(setup, task):
    from oadp_tpu.utils import load_pth as jload
    from oadp_torch.utils import load_pth

    ref_dir = setup['root'] / 'out' / f'oadp_tpu_{task}'
    our_dir = setup['root'] / 'out' / f'oadp_torch_{task}'
    assert _files(our_dir) == _files(ref_dir)
    assert len(_files(our_dir)) == len(setup['data']['ids'])
    for name in _files(ref_dir):
        ref = jload(ref_dir / name)
        ours = load_pth(our_dir / name)
        if task == 'globals':
            ref, ours = dict(embeddings=ref), dict(embeddings=ours)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype == np.float16, k
            assert ours[k].shape == ref[k].shape, k
        emb, ref_emb = ours['embeddings'], ref['embeddings']
        assert _cos(emb, ref_emb) > 0.9999
        np.testing.assert_allclose(
            emb.astype(np.float32), ref_emb.astype(np.float32), atol=2e-3
        )
        if task != 'globals':
            np.testing.assert_array_equal(ours['bboxes'], ref['bboxes'])
        if task == 'objects':
            np.testing.assert_array_equal(ours['objectness'], ref['objectness'])


def test_resume_skips_existing(setup):
    out = setup['root'] / 'out' / 'oadp_torch_objects'
    names = _files(out)
    keep = {n: (out / n).stat().st_mtime_ns for n in names[1:]}
    (out / names[0]).unlink()
    _run(setup, 'oadp_torch', 'objects', 'oadp_torch_objects')
    assert _files(out) == names
    assert {n: (out / n).stat().st_mtime_ns for n in names[1:]} == keep


def test_dry_run(setup, monkeypatch):
    from oadp_torch.utils import load_pth

    monkeypatch.setenv('DRY_RUN', '1')
    out = _run(setup, 'oadp_torch', 'objects', 'dry_objects')
    files = _files(out)
    assert len(files) == 3
    for name in files:
        assert load_pth(out / name)['embeddings'].shape[0] <= 5


def test_cuda_default_raises_without_a_card(setup):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the default runs there')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _run(setup, 'oadp_torch', 'globals', 'no_card', '.model.device:"cuda"')
    assert not (setup['root'] / 'out' / 'no_card').exists()


def test_steps_match_oadp_tpu_on_shared_inputs(setup):
    """``objects_step``, ``objects_multi_step`` and
    ``objects_packed_step`` give the same rows as ``oadp_tpu``'s on the
    same weights and inputs, at any tap bucket that covers the crops."""
    import jax.numpy as jnp

    from oadp_tpu.oake import encoders as J
    from oadp_torch.oake import encoders as T
    from oadp_torch.ops import boxes as B
    from oadp_torch.ops import preprocess as P

    ckpt = str(setup['root'] / 'clip.pt')
    jm = J.load_clip(ckpt, 'float32', vit=VIT)
    tm = T.load_clip(ckpt, 'float32', vit=VIT, device='cpu')
    js, ts = J.OakeSteps(jm, PAD, PAD), T.OakeSteps(tm, PAD, PAD)
    rng = np.random.RandomState(3)
    image = np.zeros((PAD, PAD, 3), np.uint8)
    image[:240, :300] = rng.randint(0, 256, (240, 300, 3))
    x0 = rng.uniform(0, 200, 8)
    y0 = rng.uniform(0, 150, 8)
    props = np.stack([x0, y0, x0 + rng.uniform(20, 90, 8),
                      y0 + rng.uniform(20, 90, 8)], -1).astype(np.float32)
    crops = B.expand_boxes(props, 300, 240)
    fg = props - np.concatenate([crops[:, :2], crops[:, :2]], -1)
    masks = B.grid_mask(fg, crops, tm.grid).astype(np.uint8)
    meta = P.clip_transform_meta(300, 240, crops)
    k = 21
    ref = np.asarray(js.objects_step(jnp.asarray(image), jnp.asarray(meta),
                                     jnp.asarray(masks), k))
    single = ts.objects_step(image, meta, masks, k).numpy()
    multi = ts.objects_multi_step([image], [0, 0], [meta[:4], meta[4:]],
                                  [masks[:4], masks[4:]], k).numpy()
    buf = np.stack([np.concatenate([
        image.reshape(-1), masks.reshape(-1), meta.view(np.uint8).reshape(-1)
    ])])
    assert buf.shape[1] == ts.packed_chunk_size(8)
    packed = ts.objects_packed_step(buf, 8, k).numpy()
    for got in (single, multi, packed):
        assert got.dtype == np.float16 and got.shape == ref.shape
        assert _cos(got, ref) > 0.9999
    # a larger tap bucket adds taps of weight 0: identical rows, which is
    # what lets ObjectsPipeline run a batch at its largest bucket
    np.testing.assert_array_equal(
        ts.objects_step(image, meta, masks, 49).numpy(), single
    )


def test_blocks_step_matches_oadp_tpu(setup):
    """``blocks_step`` gives ``oadp_tpu``'s rows on the same weights and
    inputs: two images with their pyramids, the wholes first, then the
    flat blocks, among them a zero padding row and a window that reaches
    past the level's edge (its start is clamped, as ``dynamic_slice``
    does)."""
    import jax.numpy as jnp

    from oadp_tpu.oake import encoders as J
    from oadp_torch.oake import encoders as T
    from oadp_torch.oake.partitions import plan_blocks
    from oadp_torch.ops import preprocess as P

    ckpt = str(setup['root'] / 'clip.pt')
    jm = J.load_clip(ckpt, 'float32', vit=VIT)
    tm = T.load_clip(ckpt, 'float32', vit=VIT, device='cpu')
    js, ts = J.OakeSteps(jm, PAD, PAD), T.OakeSteps(tm, PAD, PAD)
    rng = np.random.RandomState(5)
    images, lwx, lwy, wwx, wwy, coords = [], [], [], [], [], []
    for i, (w, h) in enumerate(((300, 250), (240, 320))):
        img = np.zeros((PAD, PAD, 3), np.uint8)
        img[:h, :w] = rng.randint(0, 256, (h, w, 3))
        plan = plan_blocks(w, h)
        mx = np.zeros((2, PAD, PAD), np.float32)
        my = np.zeros((2, PAD, PAD), np.float32)
        for k in range(len(plan.levels) - 1):
            (w0, h0), (w1, h1) = plan.levels[k], plan.levels[k + 1]
            mx[k, :w1], my[k, :h1] = P.plain_resize_matrices(w0, h0, w1, h1, PAD, PAD)
        ww, wh = P.clip_transform_matrices(w, h, None, PAD, PAD)
        images.append(img), lwx.append(mx), lwy.append(my), wwx.append(ww), wwy.append(wh)
        coords += [(i, lv, y, x) for lv, x, y in plan.blocks]
    coords += [(0, 1, 200, 150), (0, 0, 0, 0)]
    coords = np.asarray(coords, np.int32)
    ref = np.asarray(js.blocks_step(images, lwx, lwy, wwx, wwy, jnp.asarray(coords)))
    got = ts.blocks_step(images, lwx, lwy, wwx, wwy, coords).numpy()
    assert got.dtype == np.float16 and got.shape == ref.shape == (2 + len(coords), 32)
    assert _cos(got, ref) > 0.9999
    np.testing.assert_allclose(got.astype(np.float32), ref.astype(np.float32), atol=2e-3)


def test_profile_writes_trace_and_same_records(setup):
    """``profile=<dir>``: a ``torch.profiler`` trace in ``<dir>``, and records
    bit-identical to the run without it."""
    from oadp_torch.utils import load_pth

    trace_dir = setup['root'] / 'trace'
    out = _run(setup, 'oadp_torch', 'globals', 'profiled_globals',
               f'.profile:{str(trace_dir)!r}')
    traces = list(trace_dir.glob('*.pt.trace.json'))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    ref = setup['root'] / 'out' / 'oadp_torch_globals'
    assert _files(out) == _files(ref) and len(_files(out)) == len(setup['data']['ids'])
    for name in _files(ref):
        got, want = load_pth(out / name), load_pth(ref / name)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
