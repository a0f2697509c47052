"""CLIP ViT-B/32 image encoders and the CLIP text encoder in PyTorch
(port of ``oadp_tpu/models/clip.py``).

Parameters are a plain dict of tensors with the same keys as
``oadp_tpu``'s pytree: linear weights stay ``(in, out)``, so the fused
layers of :mod:`oadp_torch.ops.attention` take them as the Pallas kernels
do; only ``conv1`` keeps the OpenAI ``(D, 3, P, P)`` layout. For the CUDA
kernels, :func:`prepare_kernel_params` adds to each block a ``'kernel'``
entry once, where the parameters reach the card: the weights K-major
``(out, in)`` (the OpenAI state dict's layout) and the LayerNorms in fp32;
the encoders pass them to the fused layers explicitly. Both image
encoders pick their wiring by shape alone, as ``oadp_tpu``'s gates do on
the TPU, on every device (see :func:`image_encoder` and
:func:`image_encoder_surgery`). The fused entry points run their CUDA
kernels on the card and their plain versions on the CPU. In the fused
layers, the x-stream MLP and the stock encoder's out-projection, which
``oadp_tpu`` leaves to XLA, run on ``ln_gemm`` too
(:func:`~oadp_torch.ops.attention.ln_mlp_residual`,
:func:`~oadp_torch.ops.attention.out_proj_residual`); elsewhere (the
split wiring, :func:`_block`, the text encoder) the projections and MLPs
are ``torch`` matmuls. The patch embedding and ``ln_pre``, which
``oadp_tpu`` also leaves to XLA, take three kernels on the card in bf16
(:mod:`oadp_torch.ops.embed`: im2col rows, the product on ``ln_gemm``, CLS
+ positions + ``ln_pre``; see :func:`_embed_ln_pre`) and elsewhere a block
product (:func:`_embed_patches`).

The text encoder (:func:`text_encoder`) goes through no fused entry
point: like ``oadp_tpu``'s, it runs :func:`_block` with a causal bias,
whose attention is the exact softmax of :func:`_sdpa` (the fused layers
clamp logits at 80).

Images are ``(B, H, W, 3)`` (``oadp_tpu``'s layout) at the public
functions.
"""

__all__ = [
    'ViTConfig',
    'TextConfig',
    'init_vit_params',
    'init_text_params',
    'load_openai_state_dict',
    'load_openai_text_state_dict',
    'map_params',
    'prepare_kernel_params',
    'from_jax_params',
    'image_encoder',
    'image_encoder_surgery',
    'text_encoder',
    'upsample_vit_params',
]

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import attention as A
from ..ops import embed as EM
from ..ops import preprocess as P

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """CLIP ViT image encoder geometry (the defaults: ViT-B/32; ViT-L/14
    is patch 14, width 1024, 24 layers, 16 heads, output 768).

    ``stride < patch_size`` realises the reference's model surgery
    (half-stride conv1 + interpolated positional embedding,
    ``oadp/oake/objects.py:293-301``) without mutating the module.
    """
    image_size: int = 224
    patch_size: int = 32
    stride: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512

    @property
    def grid(self) -> int:
        if self.stride == self.patch_size:
            return self.image_size // self.patch_size
        # conv padding (patch_size - 1) // 2, per reference surgery
        pad = (self.patch_size - 1) // 2
        return (self.image_size + 2 * pad - self.patch_size) // self.stride + 1

    @property
    def tokens(self) -> int:
        return self.grid * self.grid + 1


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """CLIP text encoder geometry (ViT-B/32's text tower)."""
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    output_dim: int = 512


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _ln_init(d: int, dtype: torch.dtype) -> Params:
    return {'scale': torch.ones(d, dtype=dtype), 'bias': torch.zeros(d, dtype=dtype)}


def _init_block(randn, d: int, dtype: torch.dtype) -> Params:
    zeros = lambda n: torch.zeros(n, dtype=dtype)  # noqa: E731
    return {
        'ln_1': _ln_init(d, dtype),
        'ln_2': _ln_init(d, dtype),
        'attn': {'qkv_w': randn(d, 3 * d), 'qkv_b': zeros(3 * d),
                 'out_w': randn(d, d), 'out_b': zeros(d)},
        'mlp': {'fc_w': randn(d, 4 * d), 'fc_b': zeros(4 * d),
                'proj_w': randn(4 * d, d), 'proj_b': zeros(d)},
    }


def _randn(generator: torch.Generator, dtype: torch.dtype, scale: float):
    def randn(*shape, s=scale):
        return (torch.randn(*shape, generator=generator) * s).to(dtype)
    return randn


def init_vit_params(
    generator: torch.Generator,
    config: ViTConfig = ViTConfig(),
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random parameters with OpenAI CLIP's shapes and ``oadp_tpu``'s
    scales, drawn on the CPU from ``generator``.

    Used when no checkpoint exists. The draws do not reproduce
    ``oadp_tpu``'s ``jax.random.key(0)`` init: tests that compare the two
    packages hand both the same saved weights instead.
    """
    d, p = config.width, config.patch_size
    grid = config.image_size // p
    randn = _randn(generator, dtype, d ** -0.5)
    return {
        'conv1': randn(d, 3, p, p),
        'class_embedding': randn(d),
        'positional_embedding': randn(grid * grid + 1, d),
        'ln_pre': _ln_init(d, dtype),
        'ln_post': _ln_init(d, dtype),
        'proj': randn(d, config.output_dim),
        'blocks': [_init_block(randn, d, dtype) for _ in range(config.layers)],
    }


def init_text_params(
    generator: torch.Generator,
    config: TextConfig = TextConfig(),
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random text-encoder parameters with OpenAI CLIP's shapes and
    ``oadp_tpu``'s scales (``init_text_params``), drawn on the CPU from
    ``generator``; not ``oadp_tpu``'s draws."""
    d = config.width
    randn = _randn(generator, dtype, d ** -0.5)
    return {
        'token_embedding': randn(config.vocab_size, d, s=0.02),
        'positional_embedding': randn(config.context_length, d, s=0.01),
        'ln_final': _ln_init(d, dtype),
        'text_projection': randn(d, config.output_dim),
        'blocks': [_init_block(randn, d, dtype) for _ in range(config.layers)],
    }


def _state_reader(state: dict[str, Any]):
    """``name`` → that entry of an OpenAI CLIP state dict (tensor or numpy
    array) as an fp32 CPU tensor."""
    def a(name):
        return torch.as_tensor(np.asarray(state[name])).float()
    return a


def _state_blocks(state: dict[str, Any], prefix: str) -> list[Params]:
    """The residual blocks under ``{prefix}transformer.resblocks.``;
    ``nn.Linear`` weights are ``(out, in)`` there and are transposed to
    ``(in, out)``."""
    a = _state_reader(state)

    def block(p):
        def ln(name):
            return {'scale': a(f'{p}.{name}.weight'), 'bias': a(f'{p}.{name}.bias')}
        return {
            'ln_1': ln('ln_1'),
            'ln_2': ln('ln_2'),
            'attn': {
                'qkv_w': a(f'{p}.attn.in_proj_weight').T.contiguous(),
                'qkv_b': a(f'{p}.attn.in_proj_bias'),
                'out_w': a(f'{p}.attn.out_proj.weight').T.contiguous(),
                'out_b': a(f'{p}.attn.out_proj.bias'),
            },
            'mlp': {
                'fc_w': a(f'{p}.mlp.c_fc.weight').T.contiguous(),
                'fc_b': a(f'{p}.mlp.c_fc.bias'),
                'proj_w': a(f'{p}.mlp.c_proj.weight').T.contiguous(),
                'proj_b': a(f'{p}.mlp.c_proj.bias'),
            },
        }

    blocks = f'{prefix}transformer.resblocks.'
    n = 1 + max(
        int(k[len(blocks):].split('.')[0]) for k in state
        if k.startswith(blocks)
    )
    return [block(f'{blocks}{i}') for i in range(n)]


def load_openai_state_dict(
    state: dict[str, Any], prefix: str = 'visual.'
) -> Params:
    """Image-encoder parameters (fp32, CPU) from an OpenAI CLIP state
    dict of tensors or numpy arrays."""
    a = _state_reader(state)
    return {
        'conv1': a(f'{prefix}conv1.weight'),
        'class_embedding': a(f'{prefix}class_embedding'),
        'positional_embedding': a(f'{prefix}positional_embedding'),
        'ln_pre': {'scale': a(f'{prefix}ln_pre.weight'),
                   'bias': a(f'{prefix}ln_pre.bias')},
        'ln_post': {'scale': a(f'{prefix}ln_post.weight'),
                    'bias': a(f'{prefix}ln_post.bias')},
        'proj': a(f'{prefix}proj'),
        'blocks': _state_blocks(state, prefix),
    }


def load_openai_text_state_dict(state: dict[str, Any]) -> Params:
    """Text-encoder parameters (fp32, CPU) from the same state dict (its
    keys without a prefix), or ``{}`` when it holds no text tower (the
    text side of ``oadp_tpu``'s ``convert_torch_state_dict``)."""
    if 'token_embedding.weight' not in state:
        return {}
    a = _state_reader(state)
    return {
        'token_embedding': a('token_embedding.weight'),
        'positional_embedding': a('positional_embedding'),
        'ln_final': {'scale': a('ln_final.weight'), 'bias': a('ln_final.bias')},
        'text_projection': a('text_projection'),
        'blocks': _state_blocks(state, ''),
    }


def from_jax_params(tree: Any) -> Params:
    """``oadp_tpu``'s ViT or text parameter pytree (numpy leaves) → the
    port's dict; a ViT's ``conv1`` goes from HWIO to ``(D, 3, P, P)``."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x))

    params = conv(tree)
    if 'conv1' in params:
        params['conv1'] = params['conv1'].permute(3, 2, 0, 1).contiguous()
    return params


def map_params(params: Any, fn) -> Any:
    """Apply ``fn`` to every tensor of a parameter tree."""
    if isinstance(params, dict):
        return {k: map_params(v, fn) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_params(v, fn) for v in params]
    return fn(params)


def prepare_kernel_params(params: Params) -> Params:
    """``params`` with a ``'kernel'`` entry in every block: the copies the
    CUDA kernels read (``qkv_wt``, ``out_wt``, ``fc_wt``, ``proj_wt`` K-major
    ``(out, in)``, and ``ln_1``, ``ln_2`` as fp32 ``(scale, bias)`` pairs),
    and one at the top for the patch embedding (``conv1_wt``, ``conv1``
    K-major as ``(D, 3 * P * P)``; ``conv1_b``, the product's zero bias;
    ``ln_pre``, the fp32 pair of the scale and bias rounded to the
    parameters' dtype), made once on the parameters' device. The ``(in,
    out)`` weights stay for the plain versions and the matmuls."""

    def embed(p):
        d = p['conv1'].shape[0]
        return {
            'conv1_wt': p['conv1'].reshape(d, -1).contiguous(),
            'conv1_b': torch.zeros(d, dtype=p['conv1'].dtype, device=p['conv1'].device),
            'ln_pre': A.ln_fp32(*(p['ln_pre'][k].to(p['conv1'].dtype) for k in ('scale', 'bias'))),
        }

    def block(p):
        attn, mlp = p['attn'], p['mlp']
        return dict(p, kernel={
            'qkv_wt': A.kmajor(attn['qkv_w']),
            'out_wt': A.kmajor(attn['out_w']),
            'fc_wt': A.kmajor(mlp['fc_w']),
            'proj_wt': A.kmajor(mlp['proj_w']),
            'ln_1': A.ln_fp32(p['ln_1']['scale'], p['ln_1']['bias']),
            'ln_2': A.ln_fp32(p['ln_2']['scale'], p['ln_2']['bias']),
        })

    return dict(params, blocks=[block(p) for p in params['blocks']], kernel=embed(params))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, p: Params) -> torch.Tensor:
    """LayerNorm with fp32 statistics, rounded once to the activation
    dtype (CLIP semantics; ``F.layer_norm`` computes in fp32 for bf16)."""
    return F.layer_norm(
        x, x.shape[-1:], p['scale'].to(x.dtype), p['bias'].to(x.dtype), 1e-5
    )



def _mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    return A.mlp_plain(x, p['fc_w'], p['fc_b'], p['proj_w'], p['proj_b'])


def _ln_mlp_residual(x: torch.Tensor, p: Params) -> torch.Tensor:
    """``x + _mlp(_layer_norm(x, ln_2))`` of a fused layer, through
    :func:`~oadp_torch.ops.attention.ln_mlp_residual` (``ln_gemm`` on the
    card, the same plain order on the CPU)."""
    mlp, kern = p['mlp'], p.get('kernel', {})
    return A.ln_mlp_residual(
        x, p['ln_2']['scale'], p['ln_2']['bias'],
        mlp['fc_w'], mlp['fc_b'], mlp['proj_w'], mlp['proj_b'],
        fc_wt=kern.get('fc_wt'), proj_wt=kern.get('proj_wt'), ln32=kern.get('ln_2'),
    )


def _embed_patches(images, params: Params, config: ViTConfig):
    """Patchify + linear embed + CLS + positional embedding:
    ``(B, H, W, 3)`` → ``(B, tokens, width)``.

    The patch embedding is ``conv1`` with stride ``s`` (and, for the
    surgery's half stride, padding ``(P - 1) // 2``). With ``r = P / s``
    it is computed as one product of the image's non-overlapping ``s x
    s`` blocks with the ``r x r`` sub-kernels, fp32 sums of the ``r * r``
    shifted partial results, and one rounding. cuDNN's convolution is
    slow for this kernel/stride pair on the H100
    (``oadp_torch/profile_kernels.py`` times both).
    """
    p, s, g, d = config.patch_size, config.stride, config.grid, config.width
    if p % s:
        raise ValueError(f'stride {s} must divide the patch size {p}')
    r = p // s
    pad = 0 if s == p else (p - 1) // 2
    nb = g + r - 1  # blocks per side that the g x g windows cover
    b, h, w, _ = images.shape
    x = F.pad(images, (0, 0, pad, nb * s - w - pad, pad, nb * s - h - pad))
    blocks = x.reshape(b, nb, s, nb, s, 3).permute(0, 1, 3, 2, 4, 5)
    blocks = blocks.reshape(b * nb * nb, s * s * 3)
    k = params['conv1']  # (D, 3, P, P)
    sub = torch.cat([
        k[:, :, s * i:s * (i + 1), s * j:s * (j + 1)].permute(2, 3, 1, 0).reshape(-1, d)
        for i in range(r) for j in range(r)
    ], dim=1)  # (s*s*3, r*r*D), sub-kernel (i, j) in column block i*r+j
    part = P.matmul_f32(blocks, sub).view(b, nb, nb, r * r, d)
    x = sum(
        part[:, i:i + g, j:j + g, i * r + j]
        for i in range(r) for j in range(r)
    ).reshape(b, g * g, d).to(images.dtype)
    cls = params['class_embedding'].to(x.dtype).expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1)
    return x + params['positional_embedding'].to(x.dtype)


def _embed_on_kernels(images: torch.Tensor, config: ViTConfig) -> bool:
    return (images.device.type == 'cuda' and images.dtype == torch.bfloat16
            and EM.patch_embed_supported(config.patch_size, config.width, config.image_size))


def _embed_ln_pre(images, params: Params, config: ViTConfig):
    """``ln_pre`` of the patch embedding: ``(B, H, W, 3)`` → ``(B, tokens,
    width)``. Routed by device, dtype and shape, as ``oadp_tpu`` routes by
    its compute dtype: bf16 crops on the card, where
    :func:`~oadp_torch.ops.embed.patch_embed_supported` holds, take the
    three kernels of :func:`~oadp_torch.ops.embed.patch_embed_ln_pre`
    (im2col rows, the product on ``ln_gemm``, CLS + positions + ``ln_pre``);
    everything else :func:`_embed_patches` and :func:`_layer_norm`."""
    if _embed_on_kernels(images, config):
        kern = params.get('kernel', {})
        ln = params['ln_pre']
        return EM.patch_embed_ln_pre(
            images, params['conv1'], params['class_embedding'], params['positional_embedding'],
            ln['scale'], ln['bias'], config.stride, conv1_wt=kern.get('conv1_wt'),
            conv1_b=kern.get('conv1_b'), ln32=kern.get('ln_pre'))
    return _layer_norm(_embed_patches(images, params, config), params['ln_pre'])


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).transpose(1, 2)


def _sdpa(q, k, v, bias: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention on ``(B, h, N, d)`` → ``(B, N, h*d)`` with an
    optional additive fp32 ``bias`` broadcastable to ``(B, h, M, N)``
    (``oadp_tpu``'s ``_sdpa``): fp32 logits, exact softmax, no clamp."""
    b, h, m, d = q.shape
    logits = (q * (1.0 / math.sqrt(d))).float() @ k.float().transpose(-1, -2)
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, -1).to(v.dtype)
    return (weights @ v).transpose(1, 2).reshape(b, m, h * d)


def _self_attention_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Unbiased self-attention from a packed ``(B, N, 3D)`` qkv →
    ``(B, N, D)``: kernel 4 where its gate holds
    (``oadp_tpu/models/clip.py:227-245``)."""
    d = qkv.shape[-1] // 3
    if A.fused_mha_qkv_supported(heads, d // heads):
        return A.fused_mha_qkv(qkv, heads, 1.0 / math.sqrt(d // heads))
    return _sdpa(*(_split_heads(t, heads) for t in qkv.split(d, -1)))


def _attention(x: torch.Tensor, p: Params, heads: int,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-head self-attention with its out-projection
    (``oadp_tpu/models/clip.py:_attention``). Unbiased, from one packed
    QKV product through :func:`_self_attention_packed`; with a ``bias``,
    the kv and q products apart and :func:`_sdpa`."""
    d = x.shape[-1]
    qkv_w, qkv_b = p['qkv_w'], p['qkv_b']
    if bias is None:
        out = _self_attention_packed(x @ qkv_w + qkv_b, heads)
    else:
        k, v = (x @ qkv_w[:, d:] + qkv_b[d:]).split(d, -1)
        q = x @ qkv_w[:, :d] + qkv_b[:d]
        out = _sdpa(*(_split_heads(t, heads) for t in (q, k, v)), bias)
    return out @ p['out_w'] + p['out_b']


def _block(x: torch.Tensor, p: Params, heads: int,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """A residual block without fused layers (``oadp_tpu``'s ``_block``)."""
    x = x + _attention(_layer_norm(x, p['ln_1']), p['attn'], heads, bias)
    return x + _mlp(_layer_norm(x, p['ln_2']), p['mlp'])


def _block_fused(x: torch.Tensor, p: Params, heads: int) -> torch.Tensor:
    """A residual block with kernel 3 for LN → QKV → attention
    (``oadp_tpu``'s ``_block_fused``), then the out-projection and the MLP,
    each with its residual, on ``ln_gemm``."""
    attn, kern = p['attn'], p.get('kernel', {})
    a = A.fused_ln_qkv_attention(
        x, p['ln_1']['scale'], p['ln_1']['bias'], attn['qkv_w'], attn['qkv_b'],
        heads, 1.0 / math.sqrt(x.shape[-1] // heads),
        qkv_wt=kern.get('qkv_wt'), ln32=kern.get('ln_1'),
    )
    x = A.out_proj_residual(x, a, attn['out_w'], attn['out_b'], out_wt=kern.get('out_wt'))
    return _ln_mlp_residual(x, p)


def image_encoder(
    params: Params,
    images: torch.Tensor,
    config: ViTConfig = ViTConfig(),
) -> torch.Tensor:
    """Stock CLIP image encoder: ``(B, H, W, 3)`` → ``(B, output_dim)``
    (``oadp_tpu/models/clip.py:image_encoder``, reference
    ``oadp/oake/globals.py:57``).

    The wiring follows ``oadp_tpu``'s gate on the TPU (``_use_fused_block``),
    by shape alone and the same on every device: every block through
    kernel 3 (:func:`_block_fused`, softmax clamped at 80, the
    out-projection and MLP on ``ln_gemm``) iff ``D % 128 == 0``, else
    through :func:`_block` (exact softmax)."""
    x = _embed_ln_pre(images, params, config)
    heads = config.heads
    block_fn = (_block_fused
                if A.fused_ln_qkv_attention_supported(heads, config.width // heads)
                else _block)
    for block in params['blocks']:
        x = block_fn(x, block, heads)
    x = _layer_norm(x[:, 0], params['ln_post'])
    return x @ params['proj']


def _side_logits_concat(k, v, qy, ky, vy, bias, heads: int) -> torch.Tensor:
    """The side row where kernel 5's gate fails: softmax over the patch
    logits with y's own logit appended (``oadp_tpu/models/clip.py:
    527-552``) → ``(B, D)``."""
    b, d = qy.shape
    qh, kh, vh = (t.reshape(b, heads, 1, -1) for t in (qy, ky, vy))
    kp, vp = (_split_heads(t[:, 1:], heads) for t in (k, v))
    scale = 1.0 / math.sqrt(d // heads)
    logits_p = (qh * scale).float() @ kp.float().transpose(-1, -2)
    logit_y = (qh * scale * kh).sum(-1, keepdim=True).float()
    logits = torch.cat([logits_p, logit_y], -1) + bias[:, None, None, :]
    weights = torch.softmax(logits, -1).to(vp.dtype)
    side = weights[..., :-1] @ vp + weights[..., -1:] * vh
    return side.reshape(b, d)


def image_encoder_surgery(
    params: Params,
    images: torch.Tensor,
    masks: torch.Tensor,
    config: ViTConfig = ViTConfig(stride=16),
) -> torch.Tensor:
    """Masked attention-pool CLIP encoder (the OAKE-objects model),
    ``oadp_tpu/models/clip.py:image_encoder_surgery`` (reference
    ``oadp/oake/objects.py:198-266``).

    * the main stream ``x`` (CLS + patches) evolves through unmasked
      self-attention, as in the stock encoder;
    * a side stream ``y`` starts as the CLS token and, per block, attends
      over ``ln_1([patches, y])`` with an additive bias of ``-100`` on
      background patches (``mask == 1``), then runs its own residual MLP;
    * the embedding is ``ln_post(y) @ proj``. In the last block only the
      side stream is computed: the final ``x`` is discarded.

    The wiring follows ``oadp_tpu``'s gates on the TPU (``:448-454``), by
    shape alone and the same on every device, because it decides where
    bf16 rounds: the fused wiring (kernels 1 and 2, and the x-stream MLP
    on ``ln_gemm``) iff ``D % 128 == 0`` and the crop batch ``B % 8 == 0``;
    else the split wiring (``:499-557``)
    with the QKV and out-projections as matmuls, the main stream through
    kernel 4 and the side row through kernel 5 (or, where ``D % 128 !=
    0``, the logits-concat softmax).

    Args:
        images: ``(B, H, W, 3)`` normalized crops.
        masks: ``(B, g, g)`` background masks, 1 = background.
    """
    x = _embed_ln_pre(images, params, config)
    b = x.shape[0]
    d, heads = config.width, config.heads
    n_patches = config.grid * config.grid
    bias = torch.cat([
        masks.reshape(b, n_patches).float() * -100.0,
        torch.zeros((b, 1), dtype=torch.float32, device=x.device),
    ], dim=-1)  # (B, P+1): patch biases, then the side token's own zero
    scale = 1.0 / math.sqrt(d // heads)
    fused = (A.fused_surgery_layer_supported(heads, d // heads)
             and A.fused_ln_mlp_rows_supported(b, d))
    side_kernel = A.fused_side_attention_supported(heads, d // heads)

    y = x[:, 0].contiguous()
    last_block = len(params['blocks']) - 1
    for i, block in enumerate(params['blocks']):
        attn, mlp = block['attn'], block['mlp']
        qkv_w, qkv_b = attn['qkv_w'], attn['qkv_b']
        last = i == last_block
        if fused:
            kern = block.get('kernel', {})
            args = (x, y, bias, block['ln_1']['scale'], block['ln_1']['bias'],
                    qkv_w, qkv_b, heads, scale)
            prepared = dict(qkv_wt=kern.get('qkv_wt'), ln32=kern.get('ln_1'))
            if last:
                side = A.fused_surgery_layer(*args, with_main=False, **prepared)
                y_row = y + (side @ attn['out_w'] + attn['out_b'])
            else:
                # out-projection and both residual adds happen in the layer
                x, y_row = A.fused_surgery_layer(
                    *args, with_main=True,
                    out_w=attn['out_w'], out_b=attn['out_b'],
                    out_wt=kern.get('out_wt'), **prepared,
                )
            y = A.fused_ln_mlp_rows(
                y_row, block['ln_2']['scale'], block['ln_2']['bias'],
                mlp['fc_w'], mlp['fc_b'], mlp['proj_w'], mlp['proj_b'],
                fc_wt=kern.get('fc_wt'), proj_wt=kern.get('proj_wt'),
                ln32=kern.get('ln_2'),
            )
            if not last:
                x = _ln_mlp_residual(x, block)
            continue
        ln_x = _layer_norm(x, block['ln_1'])
        if last:
            # the final x is discarded: only K and V are projected
            k, v = (ln_x @ qkv_w[:, d:] + qkv_b[d:]).split(d, -1)
        else:
            qkv = ln_x @ qkv_w + qkv_b  # (B, N, 3D)
            _, k, v = qkv.split(d, -1)
            main = _self_attention_packed(qkv, heads)
            x = x + (main @ attn['out_w'] + attn['out_b'])
        qy, ky, vy = (_layer_norm(y, block['ln_1']) @ qkv_w + qkv_b).split(d, -1)
        if side_kernel:
            side = A.fused_side_attention(k, v, qy, ky, vy, bias, heads)
        else:
            side = _side_logits_concat(k, v, qy, ky, vy, bias, heads)
        y = y + (side @ attn['out_w'] + attn['out_b'])
        y = y + _mlp(_layer_norm(y, block['ln_2']), mlp)
        if not last:
            x = x + _mlp(_layer_norm(x, block['ln_2']), mlp)
    y = _layer_norm(y, params['ln_post'])
    return y @ params['proj']


def text_encoder(
    params: Params,
    tokens: torch.Tensor,
    config: TextConfig = TextConfig(),
) -> torch.Tensor:
    """CLIP text encoder: ``(B, context)`` integer tokens → ``(B,
    output_dim)`` (``oadp_tpu/models/clip.py:text_encoder``, OpenAI CLIP's
    ``encode_text``): every block through :func:`_block` with the causal
    ``-inf`` bias, then ``ln_final`` at the EOT token, the first position
    of the largest token id, and ``text_projection``."""
    tokens = tokens.long()
    x = params['token_embedding'][tokens]
    x = x + params['positional_embedding'][:x.shape[1]]
    n = x.shape[1]
    causal = torch.full((n, n), float('-inf'), device=x.device).triu(1)
    for block in params['blocks']:
        x = _block(x, block, config.heads, bias=causal)
    x = _layer_norm(x, params['ln_final'])
    x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
    return x @ params['text_projection']


# ---------------------------------------------------------------------------
# Surgery: positional-embedding upsampling
# ---------------------------------------------------------------------------


def _torch_bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense ``(out, in)`` matrix reproducing ``torch.nn.functional.
    interpolate(mode='bicubic', align_corners=False)``: cubic convolution
    with a = -0.75, half-pixel centers, border taps clamped (not
    renormalized). A copy of ``oadp_tpu``'s helper."""
    a = -0.75

    def k(x):
        x = np.abs(x)
        return np.where(
            x <= 1,
            ((a + 2) * x - (a + 3)) * x * x + 1,
            np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0),
        )

    out = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        x0 = math.floor(src)
        for tap in range(x0 - 1, x0 + 3):
            out[i, min(max(tap, 0), in_size - 1)] += k(src - tap)
    return out


def upsample_vit_params(
    params: Params,
    config: ViTConfig = ViTConfig(),
    upsample: int = 2,
) -> tuple[Params, ViTConfig]:
    """Interpolate the positional embedding to a ``upsample``× denser grid
    and halve the patch stride (reference ``oadp/oake/objects.py:293-301``),
    in float64 on the host as ``oadp_tpu`` does."""
    grid = config.image_size // config.patch_size
    new_grid = grid * upsample
    pe_t = params['positional_embedding']
    pe = pe_t.detach().cpu().double().numpy()
    cls_pe, patch_pe = pe[:1], pe[1:].reshape(grid, grid, -1)
    w = _torch_bicubic_weights(grid, new_grid)
    patch_pe = np.einsum('oh,hwc->owc', w, patch_pe)
    patch_pe = np.einsum('ow,hwc->hoc', w, patch_pe)
    new_pe = np.concatenate([cls_pe, patch_pe.reshape(new_grid * new_grid, -1)])
    new_params = dict(params)
    new_params['positional_embedding'] = torch.from_numpy(new_pe).to(
        dtype=pe_t.dtype, device=pe_t.device
    )
    new_config = dataclasses.replace(config, stride=config.patch_size // upsample)
    if new_config.grid != new_grid:
        raise ValueError(f'upsample {upsample} does not divide patch {config.patch_size}')
    return new_params, new_config
