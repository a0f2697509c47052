"""The port's CLIP text encoder, BPE tokenizer and ViLD prompt builder
(``oadp_torch.models.{clip,tokenizer}``, ``oadp_torch.prompts.vild``)
against ``oadp_tpu``'s, fp32 on the CPU: one shared random OpenAI-layout
state dict (text tower at width 64, 2 layers, 4 heads, context 16) fed to
both loaders, tolerances of ``tests/test_clip_parity.py`` (atol 2e-4,
rtol 1e-3) for the encoder and atol 2e-5 for the prompt embeddings."""

import functools
import gzip
import importlib.util
import pathlib
import string

import numpy as np
import pytest
import torch

from oadp_tpu.models import clip as jclip
from oadp_tpu.models import tokenizer as jtok
from oadp_tpu.prompts import vild as jvild
from oadp_torch.models import clip as tclip
from oadp_torch.models import tokenizer as ttok
from oadp_torch.prompts import vild as tvild


def _sibling(name: str):
    """A module of this directory, loaded by path: on a host where an
    installed package is also called ``tests``, ``import tests.x`` finds
    that one (this directory has no ``__init__.py``)."""
    spec = importlib.util.spec_from_file_location(f'_{name}', pathlib.Path(__file__).with_name(
        f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_leaves = _sibling('test_torch_clip')._leaves

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-3)
TEXT = dict(context_length=16, vocab_size=100, width=64, layers=2, heads=4,
            output_dim=32)
# the miniature merges file of tests/test_periphery.py
MERGES = ['version-marker', 'c a', 'ca t</w>', 'd o', 'do g</w>', 'p h', 'ph o',
          'pho t', 'phot o</w>']


def _state(seed=0, **text_geom):
    """An OpenAI-layout state dict of the test oracles: a tiny ViT and a
    text tower of ``text_geom``."""
    from tests.oracles import clip_torch

    torch.manual_seed(seed)
    visual = clip_torch.VisionTransformer(
        input_resolution=32, patch_size=16, width=64, layers=1, heads=2, output_dim=32,
    ).eval()
    text = clip_torch.TextTransformer(**text_geom).eval()
    return clip_torch.state_dict_openai_style(visual, text)


@pytest.fixture(scope='module')
def text_models():
    state = _state(**TEXT)
    _, jparams = jclip.convert_torch_state_dict(state)
    return state, jparams, jclip.TextConfig(**TEXT), tclip.TextConfig(**TEXT)


@pytest.fixture(scope='module')
def bpe_path(tmp_path_factory):
    path = tmp_path_factory.mktemp('bpe') / 'bpe.txt.gz'
    with gzip.open(path, 'wt') as f:
        f.write('\n'.join(MERGES) + '\n')
    return path


def _tokens(vocab: int, context: int) -> np.ndarray:
    """Rows with the EOT id (the largest) at the start, in the middle and
    at the end, zeros after it; the last row holds it twice (the first
    one is taken, by torch and jnp alike)."""
    rng = np.random.RandomState(3)
    eots = [1, 5, 9, context - 1, 4]
    tokens = rng.randint(1, vocab - 1, (len(eots), context)).astype(np.int32)
    for row, e in enumerate(eots):
        tokens[row, e] = vocab - 1
        tokens[row, e + 1:] = 0
    tokens[-1, 2] = vocab - 1
    return tokens


def test_text_encoder_matches(text_models):
    state, jparams, jcfg, tcfg = text_models
    tokens = _tokens(tcfg.vocab_size, tcfg.context_length)
    want = np.asarray(jclip.text_encoder(jparams, tokens, jcfg))
    got = tclip.text_encoder(
        tclip.load_openai_text_state_dict(state), torch.from_numpy(tokens), tcfg
    )
    assert got.dtype == torch.float32 and got.shape == (len(tokens), tcfg.output_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_text_encoder_takes_no_fused_entry_point(text_models, monkeypatch):
    """The text encoder's attention is the exact softmax of ``_sdpa``: no
    fused entry point (whose softmax clamps at 80) is called."""
    from oadp_torch.ops import attention as ta

    state, _, _, tcfg = text_models
    for name in ta.LAUNCHES:
        monkeypatch.setattr(ta, name, lambda *a, _n=name, **k: pytest.fail(_n))
    tclip.text_encoder(tclip.load_openai_text_state_dict(state),
                       torch.from_numpy(_tokens(tcfg.vocab_size, tcfg.context_length)), tcfg)


def test_text_from_jax_params_equals_state_dict(text_models):
    state, jparams, _, _ = text_models
    ours = dict(_leaves(tclip.load_openai_text_state_dict(state)))
    via_jax = dict(_leaves(tclip.from_jax_params(dict(jparams))))
    assert ours.keys() == via_jax.keys()
    for k in ours:
        assert ours[k].dtype == via_jax[k].dtype == torch.float32, k
        np.testing.assert_array_equal(ours[k].numpy(), via_jax[k].numpy(), k)


def test_init_text_params_shapes_match_loaded(text_models):
    state, _, _, tcfg = text_models
    init = dict(_leaves(tclip.init_text_params(torch.Generator().manual_seed(0), tcfg)))
    loaded = dict(_leaves(tclip.load_openai_text_state_dict(state)))
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in loaded.items()}
    again = dict(_leaves(tclip.init_text_params(torch.Generator().manual_seed(0), tcfg)))
    assert all(torch.equal(init[k], again[k]) for k in init)


def test_no_text_tower_loads_empty():
    state = {k: v for k, v in _state(**TEXT).items()
             if k.startswith('visual.')}
    assert tclip.load_openai_text_state_dict(state) == {}
    assert jclip.convert_torch_state_dict(state)[1] == {}


def test_build_vild_prompts_matches(bpe_path):
    jtk, ttk = jtok.SimpleTokenizer(bpe_path), ttok.SimpleTokenizer(bpe_path)
    geom = dict(context_length=16, vocab_size=len(ttk.encoder), width=32, layers=2,
                heads=2, output_dim=16)
    state = _state(seed=1, **geom)
    _, jparams = jclip.convert_torch_state_dict(state)
    names, prompts = ['cat', 'dog', 'photo'], ['a photo of a {}', 'This is a {}']
    # batch_size 2: each template's last batch of 1 is padded
    want = jvild.build_vild_prompts(jparams, jtk, names, jclip.TextConfig(**geom),
                                    batch_size=2, prompts=prompts)
    got = tvild.build_vild_prompts(tclip.load_openai_text_state_dict(state), ttk, names,
                                   tclip.TextConfig(**geom), batch_size=2, prompts=prompts)
    assert got.dtype == np.float32 and got.shape == (3, 16)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.fixture()
def tiny_vild(bpe_path, tmp_path, monkeypatch):
    """A checkpoint whose text tower fits ``vild.main``'s default
    ``TextConfig`` (context 77, 8 heads, output 512) at width 64, one
    layer; both packages' name lists cut to 3 names and their templates
    to 2."""
    from oadp_tpu.base import Categories as JCategories
    from oadp_torch.base import Categories as TCategories

    vocab = len(ttok.SimpleTokenizer(bpe_path).encoder)
    ckpt = tmp_path / 'ViT-B-32.pt'
    state = _state(seed=2, context_length=77, vocab_size=vocab, width=64, layers=1,
                   heads=8, output_dim=512)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, ckpt)
    for mod, cats in ((jvild, JCategories), (tvild, TCategories)):
        monkeypatch.setattr(mod, 'coco', cats(['dog', 'cat'], ['photo']))
        monkeypatch.setattr(mod, 'lvis', cats(['cat'], []))
        monkeypatch.setattr(mod, 'build_vild_prompts', functools.partial(
            mod.build_vild_prompts, prompts=['a photo of a {}', 'This is a {}']))
    return ckpt, state


def test_vild_main_matches(tiny_vild, bpe_path, tmp_path):
    """``python -m oadp_torch.prompts.vild --device cpu`` writes the record
    that ``oadp_tpu``'s CLI writes from the same checkpoint and merges."""
    from oadp_tpu.utils import load_pth

    ckpt, _ = tiny_vild
    outs = {}
    for name, mod, extra in (('jax', jvild, []), ('torch', tvild, ['--device', 'cpu'])):
        outs[name] = tmp_path / name / 'vild.pth'
        mod.main(['--checkpoint', str(ckpt), '--bpe', str(bpe_path),
                  '--output', str(outs[name]), *extra])
    want, got = load_pth(outs['jax']), load_pth(outs['torch'])
    assert got['names'] == want['names'] == ['cat', 'dog', 'photo']
    assert got['embeddings'].dtype == np.float32 and got['embeddings'].shape == (3, 512)
    np.testing.assert_allclose(got['embeddings'], want['embeddings'], atol=2e-5, rtol=0)


def test_vild_main_exits_without_text_tower(tiny_vild, bpe_path, tmp_path):
    _, state = tiny_vild
    vision_only = tmp_path / 'vision.pt'
    torch.save({k: torch.from_numpy(v) for k, v in state.items()
                if k.startswith('visual.')}, vision_only)
    for ckpt, what in ((tmp_path / 'missing.pt', 'cannot load'),
                       (vision_only, 'no text tower')):
        with pytest.raises(SystemExit, match=what):
            tvild.main(['--checkpoint', str(ckpt), '--bpe', str(bpe_path),
                        '--output', str(tmp_path / 'out.pth'), '--device', 'cpu'])
        assert not (tmp_path / 'out.pth').exists()


def test_vild_main_cuda_without_card_raises(tiny_vild, bpe_path, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the request is valid')
    ckpt, _ = tiny_vild
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tvild.main(['--checkpoint', str(ckpt), '--bpe', str(bpe_path),
                    '--output', str(tmp_path / 'out.pth')])


def test_tokenizer_ids_equal_on_vild_texts(bpe_path):
    """The ``re`` pattern gives ``regex``'s pieces on every ViLD text
    (every COCO/LVIS name through every template) and on
    ``string.printable``."""
    from oadp_torch.base import coco, lvis

    names = sorted(set(coco.all_ + lvis.all_))
    texts = [p.format(n) for p in tvild.PROMPTS for n in names] + [string.printable]
    assert len(texts) == 1217 * len(tvild.PROMPTS) + 1
    jtk, ttk = jtok.SimpleTokenizer(bpe_path), ttok.SimpleTokenizer(bpe_path)
    for text in texts:
        assert ttk.encode(text) == jtk.encode(text), text
    np.testing.assert_array_equal(ttok.tokenize(texts[:300], ttk),
                                  jtok.tokenize(texts[:300], jtk))


def _assigned_code_points():
    """Every code point that the interpreter's Unicode tables assign to a
    character (``regex`` may carry newer tables: the code points those add
    are ``Cn`` here and left out; surrogates, ``Cs``, have no UTF-8 form,
    and both tokenizers raise on them)."""
    import sys
    import unicodedata
    return [c for c in range(sys.maxunicode + 1)
            if unicodedata.category(chr(c)) not in ('Cn', 'Cs')]


@pytest.mark.parametrize('case', ['x_half', 'printable', 'random_unicode'])
def test_tokenizer_unicode_equal(bpe_path, case):
    """The ``re`` pattern's letter, number and rest classes split text as
    ``regex``'s ``\\p{L}``, ``\\p{N}`` and ``[^\\s\\p{L}\\p{N}]`` do:
    ``'x½'`` is two pieces (a letter, a number) for both, and the ids are
    equal on ``string.printable`` and on 3000 random strings over every
    assigned code point."""
    jtk, ttk = jtok.SimpleTokenizer(bpe_path), ttok.SimpleTokenizer(bpe_path)
    if case == 'x_half':
        texts = ['x½']
        assert ttk.pat.findall('x½') == jtk.pat.findall('x½') == ['x', '½']
    elif case == 'printable':
        texts = [string.printable, string.printable[::-1]]
    else:
        cps = np.asarray(_assigned_code_points())
        rng = np.random.default_rng(0)
        texts = [''.join(map(chr, rng.choice(cps, int(rng.integers(1, 24)))))
                 for _ in range(3000)]
    for text in texts:
        lowered = ttok._clean(text).lower()
        assert ttk.pat.findall(lowered) == jtk.pat.findall(lowered), repr(text)
        assert ttk.encode(text) == jtk.encode(text), repr(text)


def test_smoke_checkpoint_round_trips():
    """``chip_smoke.py``'s OpenAI-layout writer and its synthetic merges
    file: the port's loaders read back the trees it wrote, and the merges
    give the tokenizer a CLIP vocabulary's 49,408 ids."""
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    vit = tclip.init_vit_params(gen, tclip.ViTConfig(
        image_size=32, patch_size=16, width=64, layers=2, heads=2, output_dim=16))
    text = tclip.init_text_params(gen, tclip.TextConfig(**TEXT))
    state = chip_smoke.openai_state_dict(vit, text)
    for want, got in ((vit, tclip.load_openai_state_dict(state)),
                      (text, tclip.load_openai_text_state_dict(state))):
        want, got = dict(_leaves(want)), dict(_leaves(got))
        assert want.keys() == got.keys()
        assert all(torch.equal(want[k], got[k]) for k in want)


def test_smoke_merges_give_clip_vocabulary(tmp_path):
    import chip_smoke

    chip_smoke.write_bpe(tmp_path / 'bpe.txt.gz')
    tk = ttok.SimpleTokenizer(tmp_path / 'bpe.txt.gz')
    assert len(tk.encoder) == 49408 and tk.eot == 49407
    ids = ttok.tokenize([p.format('traffic light') for p in tvild.PROMPTS], tk)
    assert (ids.max(-1) == tk.eot).all() and ids.shape == (len(tvild.PROMPTS), 77)
