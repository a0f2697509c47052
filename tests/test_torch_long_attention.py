"""Attention past 256 tokens: CLIP ViT-L/14 under OADP's surgery (14-px
patches at stride 7, a 32 x 32 grid, 1,025 tokens a crop).

On the CPU, against the benchmark's plain float32 reference
(``benchmark/reference/clip_vit.py``, which imports no JAX): the port's
surgery encoder at L/14's geometry and a reduced width, the plain
attention at 1,025 tokens with the side row and its -100 bias, the clamp,
the route by N and its counters, ``load_clip``'s geometry from a state
dict, and the reader of the route's share. The ``cuda``-marked tests run
the ``long_attention`` kernel (``csrc/long_attention.cu``) against the
plain version on the card and hold one traced L/14 layer to the
benchmark's launch check (``python3 -m pytest -m cuda
tests/test_torch_long_attention.py`` on a machine with the card).
"""

import math

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import clip_vit
from oadp_torch.models import clip as C
from oadp_torch.oake import encoders as E
from oadp_torch.ops import attention as A
from oadp_torch.utils.tracing import Span

torch.set_num_threads(1)

# L/14's geometry at a reduced width: 2 heads of 64, 2 layers
L14 = dict(image_size=224, patch_size=14, width=128, layers=2, heads=2, output_dim=64,
           surgery_stride=7)


def test_l14_geometry_gives_1025_tokens():
    vit = C.ViTConfig(image_size=224, patch_size=14, stride=14, width=1024, layers=24,
                      heads=16, output_dim=768)
    _, surgery = C.upsample_vit_params(
        dict(positional_embedding=torch.zeros(257, 8)), vit, 14 // 7)
    assert (surgery.stride, surgery.grid, surgery.tokens) == (7, 32, 1025)
    assert clip_vit.grid(dict(L14)) == 32


@pytest.mark.parametrize('b', [4, 8])
def test_surgery_encoder_at_l14_geometry_matches_reference(b):
    """``image_encoder_surgery`` at patch 14, stride 7 (1,025 tokens, a
    32 x 32 mask grid) on seeded random weights against the float32
    reference, with random background masks: B = 8 takes the fused
    wiring, B = 4 the split one. Tolerance: both run in float32; they
    differ in the order of sums (the patch product as shifted block
    products, the fp32 bicubic positions in float64 by matrix or by
    ``F.interpolate``, softmax with and without the max subtracted), which
    leaves about 1e-6 of the embedding's scale; 2e-4 holds that with room
    and fails a dropped bias, side row or layer by orders of magnitude."""
    cfg = dict(L14)
    params = clip_vit.random_params(cfg, 2 ** 31 + 5, 'cpu', torch.float32)
    gen = torch.Generator().manual_seed(b)
    pixels = torch.randn(b, 3, 224, 224, generator=gen)
    background = torch.rand(b, 32, 32, generator=gen) > 0.5
    want = clip_vit.surgery_encode(params, pixels, background, cfg,
                                   clip_vit.surgery_positions(params, cfg))
    vit = C.ViTConfig(image_size=224, patch_size=14, stride=14, width=128, layers=2, heads=2,
                      output_dim=64)
    surgery, config = C.upsample_vit_params(params, vit, 2)
    got = C.image_encoder_surgery(surgery, pixels.permute(0, 2, 3, 1), background.float(),
                                  config)
    assert got.shape == want.shape == (b, 64)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 2e-4 * scale, (err, scale)


def _qkv(rng, b, n, heads, scale=1.0):
    d = heads * 64
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * d)).astype(np.float32))
    qkv_y = torch.from_numpy(rng.standard_normal((b, 3 * d)).astype(np.float32))
    qkv[..., :d] *= scale
    qkv_y[..., :d] *= scale
    bias = torch.cat([(torch.from_numpy(rng.random((b, n - 1))) > 0.5).float() * -100.0,
                      torch.zeros(b, 1)], 1)
    return qkv, qkv_y, bias


def test_plain_route_at_1025_tokens_matches_reference_attend():
    """The plain main rows and side row at N = 1,025 against the
    reference's ``_attend`` (softmax with the max subtracted): the side
    row over ``[k[1:], ky]`` with the -100 bias on background patches.
    Float32 both; they differ in rounding alone (1e-6)."""
    b, n, heads = 2, 1025, 2
    d = heads * 64
    qkv, qkv_y, bias = _qkv(np.random.default_rng(7), b, n, heads)
    q, k, v = qkv.split(d, -1)
    qy, ky, vy = qkv_y.split(d, -1)
    scale = 1 / 8
    main = A._main_attention(qkv, heads, scale)
    side = A._side_attention(k, v, qy, ky, vy, bias, heads, scale)
    want_main = clip_vit._attend(q, k, v, heads, clip_vit.exact)
    want_side = clip_vit._attend(qy[:, None], torch.cat([k[:, 1:], ky[:, None]], 1),
                                 torch.cat([v[:, 1:], vy[:, None]], 1), heads,
                                 clip_vit.exact, bias)[:, 0]
    torch.testing.assert_close(main, want_main, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(side, want_side, atol=1e-5, rtol=1e-5)
    # the bias does its work: the background patches weigh nothing
    free = A._side_attention(k, v, qy, ky, vy, torch.zeros_like(bias), heads, scale)
    assert float((free - side).abs().max()) > 0.05


def test_plain_route_clamps_logits_above_80_at_1025_tokens():
    """A logit row above ``LOGIT_CLAMP``: the plain version weighs every
    key at or past 80 as e^80, so its result is the mean of those keys'
    values, not the softmax's pick of the largest logit."""
    b, n, heads = 1, 1025, 1
    d = 64
    qkv, _, _ = _qkv(np.random.default_rng(9), b, n, heads)
    q, k, v = qkv.split(d, -1)
    k[0, :3] = q[0, 0] * 40 / float(q[0, 0].square().sum())  # logits 40, 40, 40 at scale 1
    k[0, 1] *= 3  # 120
    k[0, 2] *= 2  # 80
    k[0, 0] *= 5  # 200
    out = A._main_attention(torch.cat([q, k, v], -1), heads, 1.0)
    logits = q[0, 0] @ k[0].T
    assert float(logits.max()) > 150 and float(logits.sort().values[-3]) >= 79.99
    e = torch.exp(torch.clamp(logits, max=A.LOGIT_CLAMP))
    want = (e @ v[0]) / e.sum()
    torch.testing.assert_close(out[0, 0], want, atol=1e-4, rtol=1e-4)
    assert float((want - v[0, 0]).abs().max()) > 0.1  # the softmax would give v[0]
    softmax = clip_vit._attend(q, k, v, heads, clip_vit.exact)
    assert float((softmax[0, 0] - v[0, 0]).abs().max()) < 1e-3


class _FakeLib:
    def __init__(self):
        self.calls = []

    def oadp_attention(self, b, n, heads, scale, *args):
        self.calls.append(('attention', n))
        return 0

    def oadp_long_attention(self, b, n, heads, scale, *args):
        self.calls.append(('long_attention', n))
        return 0


def test_attention_routes_by_n_and_counts_each_route(monkeypatch):
    """``_attention`` launches ``attention`` up to 256 tokens and
    ``long_attention`` past them, one launch a call either way, counted in
    ``ROUTES`` (the launch itself faked: this host has no card)."""
    lib = _FakeLib()
    monkeypatch.setattr(A.cuda_lib, 'library', lambda: lib)
    monkeypatch.setattr(A, '_strided', lambda t: (None, 0, 0) if t is None else (1, 0, 0))
    monkeypatch.setattr(A, '_stream', lambda: 0)
    A.reset_launches()
    for n in (197, 256, 257, 1025):
        qkv, qkv_y, bias = _qkv(np.random.default_rng(n), 2, n, 2)
        q, k, v = qkv.split(128, -1)
        qy, ky, vy = qkv_y.split(128, -1)
        A._attention(q, k, v, 2, 0.125, out=torch.empty_like(q), qy=qy, ky=ky, vy=vy,
                     bias=bias, side=torch.empty_like(qy))
    A._attention(None, k, v, 2, 0.125, qy=qy, ky=ky, vy=vy, bias=bias,
                 side=torch.empty_like(qy))
    assert lib.calls == [('attention', 197), ('attention', 256), ('long_attention', 257),
                         ('long_attention', 1025), ('long_attention', 1025)]
    assert A.ROUTES == {'attention': 2, 'long_attention': 3}
    assert E._attn_counts() == dict(attn_launches=5, attn_long_launches=3)
    with pytest.raises(ValueError, match='unsupported shape'):
        big = torch.empty(1, 4097, 128)
        A._attention(big, big, big, 2, 0.125, out=big)
    A.reset_launches()
    assert A.ROUTES == {'attention': 0, 'long_attention': 0}


def _openai_visual(width, patch, grid, layers, output_dim):
    """A tiny OpenAI-layout visual state dict (random values)."""
    g = torch.Generator().manual_seed(width + patch)
    r = lambda *s: torch.randn(*s, generator=g) * 0.02  # noqa: E731
    state = {'visual.conv1.weight': r(width, 3, patch, patch),
             'visual.class_embedding': r(width),
             'visual.positional_embedding': r(grid * grid + 1, width),
             'visual.proj': r(width, output_dim)}
    for ln in ('ln_pre', 'ln_post'):
        state[f'visual.{ln}.weight'] = 1 + r(width)
        state[f'visual.{ln}.bias'] = r(width)
    for i in range(layers):
        p = f'visual.transformer.resblocks.{i}'
        for ln in ('ln_1', 'ln_2'):
            state[f'{p}.{ln}.weight'] = 1 + r(width)
            state[f'{p}.{ln}.bias'] = r(width)
        state.update({
            f'{p}.attn.in_proj_weight': r(3 * width, width), f'{p}.attn.in_proj_bias': r(3 * width),
            f'{p}.attn.out_proj.weight': r(width, width), f'{p}.attn.out_proj.bias': r(width),
            f'{p}.mlp.c_fc.weight': r(4 * width, width), f'{p}.mlp.c_fc.bias': r(4 * width),
            f'{p}.mlp.c_proj.weight': r(width, 4 * width), f'{p}.mlp.c_proj.bias': r(width),
        })
    return state


def test_load_clip_reads_the_geometry_from_the_state_dict(tmp_path):
    """An L/14-shaped state dict (14-px patches, a 16 x 16 grid, width 128,
    2 layers) gives L/14's geometry with heads width / 64, and its surgery
    the 32 x 32 grid; a ``vit`` that restates it agrees, one that
    disagrees raises; a B/32-shaped one gives B/32's geometry."""
    path = tmp_path / 'l14.pt'
    torch.save(_openai_visual(128, 14, 16, 2, 64), path)
    model = E.load_clip(str(path), 'float32', device='cpu')
    assert model.config == C.ViTConfig(image_size=224, patch_size=14, stride=14, width=128,
                                       layers=2, heads=2, output_dim=64)
    assert (model.surgery_config.stride, model.grid, model.surgery_config.tokens) == (7, 32, 1025)
    assert len(model.params['blocks']) == 2
    assert E.load_clip(str(path), 'float32', vit=dict(patch_size=14, width=128, heads=1),
                       device='cpu').config.heads == 1
    with pytest.raises(ValueError, match='disagrees'):
        E.load_clip(str(path), 'float32', vit=dict(patch_size=32), device='cpu')
    with pytest.raises(ValueError, match='disagrees'):
        E.load_clip(str(path), 'float32', vit=dict(layers=24), device='cpu')
    b32 = tmp_path / 'b32.pt'
    torch.save(_openai_visual(64, 32, 7, 1, 32), b32)
    assert E.load_clip(str(b32), 'float32', device='cpu').config == C.ViTConfig(
        width=64, layers=1, heads=1, output_dim=32)
    # without a checkpoint: random weights of vit's geometry, B/32 by default
    assert E.load_clip(None, 'float32', device='cpu').config == C.ViTConfig()
    assert E.load_clip(None, 'float32', vit=dict(patch_size=14, width=64, layers=1, heads=1),
                       device='cpu').config.stride == 14


def test_objects_vitl14_config_names_the_l14_checkpoint():
    from oadp_torch.utils import Config
    cfg = Config.load('configs/oake/objects_coco_vitl14.py')
    assert cfg.model.checkpoint == 'pretrained/clip/ViT-L-14.pt'
    assert cfg.mini_batch_size == 1024 and cfg.model.max_image_size == 640


# ---------------------------------------------------------------------------
# The reader of oake.long_attention_pct
# ---------------------------------------------------------------------------

WINDOW = (10.0, 11.0)


def _ctx():
    outcome = harness.Outcome(window=WINDOW, spans=harness.Spans(), counts={}, checks={},
                              attempted=0, failed=0, memory_peak_bytes=0, trace=object())
    return harness.Ctx(spec=None, outcome=outcome)


def _launch(t0, counts):
    return Span('step.launch', 'MainThread', t0, t0 + 0.01, 0.0, counts=counts)


@pytest.mark.parametrize('spans, want', [
    # before the window, in it, at its close: only the two inside count
    ([_launch(9.9, dict(attn_launches=24, attn_long_launches=0)),
      _launch(10.1, dict(attn_launches=24, attn_long_launches=24)),
      _launch(10.5, dict(attn_launches=24, attn_long_launches=12)),
      _launch(11.0, dict(attn_launches=24, attn_long_launches=0))], 75.0),
    ([_launch(10.1, dict(attn_launches=12, attn_long_launches=0))], 0.0),
    # a program whose launch spans count no routes, or no attention launch
    ([_launch(10.1, None), _launch(10.2, None)], None),
    ([_launch(10.1, dict(attn_launches=0, attn_long_launches=0))], None),
    ([Span('runner.fetch', 'MainThread', 10.1, 10.2, 0.0, counts=dict(attn_launches=5))], None),
], ids=['window', 'short-route', 'no-counters', 'no-launch', 'other-span'])
def test_long_attention_pct_reads_the_launch_counters(monkeypatch, spans, want):
    from oadp_torch.utils import tracing
    monkeypatch.setattr(tracing, 'spans', lambda: spans)
    got = harness.load_module('metrics', 'oake.long_attention_pct').read(_ctx())
    assert got == want


def test_long_attention_pct_is_none_without_a_trace():
    ctx = _ctx()
    ctx.outcome.trace = None
    assert harness.load_module('metrics', 'oake.long_attention_pct').read(ctx) is None


# ---------------------------------------------------------------------------
# The build's ptxas report of the kernel (read on the card by chip_smoke)
# ---------------------------------------------------------------------------

_KERNEL = '_ZN4oadp12_GLOBAL__N_121long_attention_kernelE14CUtensorMap_stS2_S2_NS0_4ArgsE'
_LN = '_ZN4oadp12_GLOBAL__N_117layer_norm_kernelEPK13__nv_bfloat16iS4_iiPKfS6_PS2_'


def _ptxas_section(source, kernel, spills, registers, warning=''):
    return '\n'.join([
        f'== {source}',
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{_LN}' for 'sm_90a'",
        f"ptxas info    : Function properties for {_LN}",
        "    0 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 60 registers, 400 bytes cmem[0]",
        *([warning] if warning else []),
        f"ptxas info    : Compiling entry function '{kernel}' for 'sm_90a'",
        f"ptxas info    : Function properties for {kernel}",
        f"    {spills} bytes stack frame, {spills} bytes spill stores, {spills} bytes spill loads",
        f"ptxas info    : Used {registers} registers, 16 bytes smem, 1104 bytes cmem[0]",
    ])


@pytest.mark.parametrize('spills, warning, fails', [
    (0, '', False),
    (8, '', True),
    (0, "ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions "
        "are serialized due to program dependence on compiler-inserted WG.AR in divergent path "
        f"in the function '{_KERNEL}'", True),
], ids=['clean', 'spills', 'serialized'])
def test_ptxas_report_reads_the_kernels_section(monkeypatch, tmp_path, spills, warning, fails):
    """``chip_smoke.ptxas_report`` reads ``long_attention_kernel``'s
    registers, spills and static shared memory from its own source's
    section of ``build.log`` (another kernel's spills in the same section,
    and another source's section, are not its own), and
    ``long_attention_build`` fails on spills or a serialised wgmma."""
    import chip_smoke
    from oadp_torch.ops import cuda_lib

    text = '\n'.join([_ptxas_section('attention.cu', _KERNEL, 64, 128),
                      _ptxas_section('long_attention.cu', _KERNEL, spills, 168, warning),
                      '== nms.cu', 'ptxas info    : 0 bytes gmem'])
    report = chip_smoke.ptxas_report(text, 'long_attention.cu', 'long_attention_kernel')
    assert (report['registers'], report['spill_stores'], report['spill_loads'],
            report['static_smem_bytes']) == (168, spills, spills, 16)
    assert len(report['serialized']) == bool(warning)
    monkeypatch.setattr(cuda_lib, 'build_dir', lambda: tmp_path)
    (tmp_path / 'build.log').write_text(text)
    if fails:
        with pytest.raises(AssertionError, match='long_attention_kernel'):
            chip_smoke.long_attention_build()
    else:
        assert chip_smoke.long_attention_build() == report
    with pytest.raises(AssertionError, match='no section'):
        chip_smoke.ptxas_report(text, 'embed.cu', 'long_attention_kernel')
    with pytest.raises(AssertionError, match='no ptxas report'):
        chip_smoke.ptxas_report(text, 'nms.cu', 'long_attention_kernel')


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _card_inputs(dev, b, n, heads, scale_q, seed):
    """bf16 packed qkv and side rows, and random -100 masks, on the card."""
    d = heads * 64
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, n, 3 * d, device=dev, generator=g)
    qkv_y = torch.randn(b, 3 * d, device=dev, generator=g)
    qkv[..., :d] *= scale_q
    qkv_y[..., :d] *= scale_q
    mask = torch.rand(b, n - 1, device=dev, generator=g) > 0.5
    bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
    return qkv.bfloat16(), qkv_y.bfloat16(), bias


@pytest.mark.cuda
@pytest.mark.parametrize('n, b, heads, mode, scale', [
    (1025, 2048, 16, 'both', 0.4),  # an L/14 objects dispatch
    (1025, 2048, 16, 'side', 0.4),  # its last layer
    (197, 2048, 12, 'both', 0.4),  # B/32's objects dispatch, routed here for the test
    (257, 8, 4, 'both', 0.4),  # a partial last K/V tile of 1 key
    (512, 8, 4, 'both', 0.4),  # the side row in a tile of its own
    (1025, 8, 4, 'both', 4.0),  # logits far above the clamp
    (1025, 16, 16, 'main', 0.4),
    (1025, 16, 16, 'side', 0.4),  # the last layer: the side row alone
    (300, 5, 4, 'main', 0.4),
    (2305, 4, 4, 'both', 0.4),  # a 336-px L/14 tower's 48 x 48 grid
    # the edges of the 64-row tiles (an item's main rows, then the side
    # row, cut into tiles of 64 rows, three tiles a work unit)
    (1087, 8, 4, 'both', 0.4),  # the last tile: 63 main rows and the side row
    (1088, 8, 4, 'both', 0.4),  # 17 tiles of main rows, the side row alone past them
    (1089, 8, 4, 'both', 0.4),  # the last tile: one main row and the side row; a 1-key tile
    (1025, 37, 4, 'both', 0.4),  # units that do not divide among the blocks
    (2305, 4, 4, 'side', 0.4),
])
def test_long_attention_matches_plain_on_card(n, b, heads, mode, scale, monkeypatch):
    """``long_attention`` against the plain version in bf16, the plain
    version a chunk of crops at a time (its fp32 logits of a whole
    dispatch would take 137 GB): a cosine of at least 0.999 and every
    output within two bf16 units in the last place of the chunk's largest
    output (both round fp32 sums taken in another order to bf16, so a
    rounding may fall the other way: at B = 2048 one output of about 5
    did, by 0.03125). At N <= 256, where the route takes ``attention``,
    the test lowers the route's threshold below N."""
    dev = _card()
    d = heads * 64
    qkv, qkv_y, bias = _card_inputs(dev, b, n, heads, 1.0, n + b)
    q, k, v = qkv.split(d, -1)
    qy, ky, vy = qkv_y.split(d, -1)
    main = torch.empty((b, n, d), dtype=torch.bfloat16, device=dev) if mode != 'side' else None
    side = torch.empty((b, d), dtype=torch.bfloat16, device=dev) if mode != 'main' else None
    side_args = dict(qy=qy, ky=ky, vy=vy, bias=bias, side=side) if side is not None else {}
    monkeypatch.setattr(A, '_MAX_TOKENS', min(A._MAX_TOKENS, n - 1))
    A.reset_launches()
    A._attention(q if main is not None else None, k, v, heads, scale, out=main, **side_args)
    assert A.ROUTES == {'attention': 0, 'long_attention': 1}
    torch.cuda.synchronize()
    step = max(1, (1 << 32) // (heads * n * n * 4))
    for c in range(0, b, step):
        sl = slice(c, c + step)
        if main is not None:
            want = A._main_attention(qkv[sl], heads, scale)
            _close(main[sl], want)
        if side is not None:
            want = A._side_attention(k[sl], v[sl], qy[sl], ky[sl], vy[sl], bias[sl], heads,
                                     scale)
            _close(side[sl], want)
        torch.cuda.empty_cache()


def _close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got.flatten(1), want.flatten(1))
    assert float(cos.min()) > 0.999
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    assert float((got - want).abs().max()) <= 2 * ulp


def _layer_args(dev, b, n, heads, seed):
    d = heads * 64
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).bfloat16()  # noqa: E731
    mask = torch.rand(b, n - 1, device=dev, generator=g) > 0.5
    bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
    args = (r(b, n, d), r(b, d), bias, 1 + r(d, sc=0.1), r(d, sc=0.1), r(d, 3 * d, sc=d ** -0.5),
            r(3 * d, sc=0.02), heads, 1 / 8)
    return args, dict(out_w=r(d, d, sc=d ** -0.5), out_b=r(d, sc=0.02))


@pytest.mark.cuda
def test_traced_layers_pass_the_benchmarks_launch_check(tmp_path):
    """One L/14 surgery layer (N = 1,025, fused wiring, fold_out) and its
    last layer (the side row alone) under a profiler session, held to
    ``benchmark.trace.check_launches``: the new kernel is of the
    ``attention_kernel`` class and counted once a call under
    ``fused_surgery_layer``. A B/32 layer (N = 197) still launches the old
    kernel alone."""
    from benchmark import trace as T
    from benchmark.metrics import kernel_parts

    dev = _card()
    runs = {}
    for name, n, heads in (('l14', 1025, 16), ('b32', 197, 12)):
        args, fold = _layer_args(dev, 16, n, heads, n)
        A.fused_surgery_layer(*args, **fold)  # warm: build, first launch
        torch.cuda.synchronize()
        session = T.Session().start()
        A.fused_surgery_layer(*args, **fold)
        A.fused_surgery_layer(*args, with_main=False)
        traced = session.stop(tmp_path / f'{name}.json')
        assert traced.launches['attention_kernel'] == [2, 2]
        runs[name] = [k for k, _, _ in traced.kernels
                      if kernel_parts.part(k) == 'attention_kernel']
    assert len(runs['l14']) == 2 and all('long_attention_kernel' in k for k in runs['l14'])
    assert len(runs['b32']) == 2 and not any('long_attention' in k for k in runs['b32'])
