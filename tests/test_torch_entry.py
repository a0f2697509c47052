"""``oadp_torch.entry`` against ``__graft_entry__.py`` on the CPU: the dry run
of a full train step over two gloo processes and over one; the refusal of
the default card where there is none, by ``entry()`` and by the CLI; and its OAKE-objects forward step (fp32,
the CPU) against ``__graft_entry__.entry()``'s on the same inputs with the
same ViT-B/32 weights (a random state dict of ``tests/oracles``)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def test_dryrun_two_processes():
    from oadp_torch import entry

    entry.dryrun_multichip(2, device='cpu')


def test_dryrun_one_process():
    """A group of one process runs the same step (the default on a host
    with one card)."""
    from oadp_torch import entry

    entry.dryrun_multichip(1, device='cpu')


def test_main_refuses_default_card_where_there_is_none():
    from oadp_torch import entry

    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device runs')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        entry.main(['2'])


def test_dryrun_refuses_more_cards_than_present():
    from oadp_torch import entry

    with pytest.raises(RuntimeError, match='CUDA devices'):
        entry.dryrun_multichip(torch.cuda.device_count() + 1, device='cuda')


def test_entry_without_card_raises():
    from oadp_torch import entry

    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device runs')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        entry.entry()


def test_objects_step_equals_graft_entry(tmp_path):
    """The step ``entry()`` returns (``OakeSteps.objects_step``), on the CPU
    in fp32, against ``__graft_entry__.entry()``'s on the inputs it draws,
    with the same ViT-B/32 weights: unit embeddings within 2e-3 abs
    (cosine >= 0.9999)."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from oadp_torch import entry
    from oadp_torch.oake.encoders import OakeSteps, load_clip
    from oadp_tpu.models import clip as jclip
    from tests.oracles import clip_torch

    jfn, (_, jimage, jmeta, jmasks) = graft.entry()
    torch.manual_seed(0)
    visual = clip_torch.VisionTransformer(input_resolution=224, patch_size=32, width=768,
                                          layers=12, heads=12, output_dim=512).eval()
    jparams, _ = jclip.convert_torch_state_dict(clip_torch.state_dict_openai_style(visual))
    jparams, _ = jclip.upsample_vit_params(jparams, jclip.ViTConfig())
    want = np.asarray(jax.jit(jfn)(jax.tree.map(jnp.asarray, jparams), jimage, jmeta, jmasks))

    ckpt = tmp_path / 'clip.pt'
    torch.save(clip_torch.state_dict_openai_style(visual, numpy=False), ckpt)
    model = load_clip(str(ckpt), 'float32', device='cpu')
    image, meta, masks = entry._example_inputs(model.grid)
    np.testing.assert_array_equal(image, np.asarray(jimage))
    np.testing.assert_array_equal(meta, np.asarray(jmeta))
    np.testing.assert_array_equal(masks, np.asarray(jmasks))
    got = OakeSteps(model, entry.PAD, entry.PAD).objects_step(
        image, meta, masks, entry.K_PAD).numpy()
    assert got.shape == want.shape == (entry.BATCH, 512)
    cos = (got.astype(np.float64) * want).sum(-1)
    assert cos.min() >= 0.9999, cos.min()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
