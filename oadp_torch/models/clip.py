"""CLIP ViT-B/32 image encoders in PyTorch (port of
``oadp_tpu/models/clip.py``; the text encoder is not ported yet).

Parameters are a plain dict of tensors with the same keys as
``oadp_tpu``'s pytree: linear weights stay ``(in, out)``, so the fused
layers of :mod:`oadp_torch.ops.attention` take them as the Pallas kernels
do; only ``conv1`` keeps the OpenAI ``(D, 3, P, P)`` layout. For the CUDA
kernels, :func:`prepare_kernel_params` adds to each block a ``'kernel'``
entry once, where the parameters reach the card: the weights K-major
``(out, in)`` (the OpenAI state dict's layout) and the LayerNorms in fp32;
the encoders pass them to the fused layers explicitly. The stock
encoder takes the fused wiring of ``oadp_tpu``'s TPU branch; the surgery
encoder picks its wiring by shape alone, as ``oadp_tpu``'s gates do on
the TPU, on every device (see :func:`image_encoder_surgery`). The fused
entry points run their CUDA kernels on the card and their plain
versions on the CPU. The QKV and out-projections and the MLPs that
``oadp_tpu`` leaves to XLA are ``torch`` matmuls here, and the patch
embedding is a block product (see :func:`_embed_patches`).

Images are ``(B, H, W, 3)`` (``oadp_tpu``'s layout) at the public
functions.
"""

__all__ = [
    'ViTConfig',
    'init_vit_params',
    'load_openai_state_dict',
    'map_params',
    'prepare_kernel_params',
    'from_jax_params',
    'image_encoder',
    'image_encoder_surgery',
    'upsample_vit_params',
]

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import attention as A
from ..ops import preprocess as P

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT-B/32 image encoder geometry.

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


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


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
    scale = d ** -0.5
    grid = config.image_size // p

    def randn(*shape, s=scale):
        return (torch.randn(*shape, generator=generator) * s).to(dtype)

    def ln():
        return {'scale': torch.ones(d, dtype=dtype),
                'bias': torch.zeros(d, dtype=dtype)}

    def block():
        return {
            'ln_1': ln(),
            'ln_2': ln(),
            'attn': {
                'qkv_w': randn(d, 3 * d),
                'qkv_b': torch.zeros(3 * d, dtype=dtype),
                'out_w': randn(d, d),
                'out_b': torch.zeros(d, dtype=dtype),
            },
            'mlp': {
                'fc_w': randn(d, 4 * d),
                'fc_b': torch.zeros(4 * d, dtype=dtype),
                'proj_w': randn(4 * d, d),
                'proj_b': torch.zeros(d, dtype=dtype),
            },
        }

    return {
        'conv1': randn(d, 3, p, p),
        'class_embedding': randn(d),
        'positional_embedding': randn(grid * grid + 1, d),
        'ln_pre': ln(),
        'ln_post': ln(),
        'proj': randn(d, config.output_dim),
        'blocks': [block() for _ in range(config.layers)],
    }


def load_openai_state_dict(
    state: dict[str, Any], prefix: str = 'visual.'
) -> Params:
    """Image-encoder parameters (fp32, CPU) from an OpenAI CLIP state
    dict of tensors or numpy arrays. ``nn.Linear`` weights are ``(out,
    in)`` there and are transposed to ``(in, out)``."""

    def a(name):
        return torch.as_tensor(np.asarray(state[name])).float()

    def block(p):
        return {
            'ln_1': {'scale': a(f'{p}.ln_1.weight'), 'bias': a(f'{p}.ln_1.bias')},
            'ln_2': {'scale': a(f'{p}.ln_2.weight'), 'bias': a(f'{p}.ln_2.bias')},
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
    return {
        'conv1': a(f'{prefix}conv1.weight'),
        'class_embedding': a(f'{prefix}class_embedding'),
        'positional_embedding': a(f'{prefix}positional_embedding'),
        'ln_pre': {'scale': a(f'{prefix}ln_pre.weight'),
                   'bias': a(f'{prefix}ln_pre.bias')},
        'ln_post': {'scale': a(f'{prefix}ln_post.weight'),
                    'bias': a(f'{prefix}ln_post.bias')},
        'proj': a(f'{prefix}proj'),
        'blocks': [block(f'{blocks}{i}') for i in range(n)],
    }


def from_jax_params(tree: Any) -> Params:
    """``oadp_tpu``'s ViT parameter pytree (numpy leaves) → the port's
    dict; ``conv1`` goes from HWIO to ``(D, 3, P, P)``."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x))

    params = conv(tree)
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
    made once on the parameters' device. The ``(in, out)`` weights stay for
    the plain versions and the matmuls."""

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

    return dict(params, blocks=[block(p) for p in params['blocks']])


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
    h = torch.addmm(p['fc_b'], x.reshape(-1, x.shape[-1]), p['fc_w'])
    h = h.mul_(torch.sigmoid(1.702 * h))  # quick_gelu
    out = torch.addmm(p['proj_b'], h, p['proj_w'])
    return out.reshape(x.shape)


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


def image_encoder(
    params: Params,
    images: torch.Tensor,
    config: ViTConfig = ViTConfig(),
) -> torch.Tensor:
    """Stock CLIP image encoder: ``(B, H, W, 3)`` → ``(B, output_dim)``
    (``oadp_tpu/models/clip.py:image_encoder`` with the ``_block_fused``
    wiring, reference ``oadp/oake/globals.py:57``)."""
    x = _layer_norm(_embed_patches(images, params, config), params['ln_pre'])
    scale = 1.0 / math.sqrt(config.width // config.heads)
    for block in params['blocks']:
        attn, kern = block['attn'], block.get('kernel', {})
        a = A.fused_ln_qkv_attention(
            x, block['ln_1']['scale'], block['ln_1']['bias'],
            attn['qkv_w'], attn['qkv_b'], config.heads, scale,
            qkv_wt=kern.get('qkv_wt'), ln32=kern.get('ln_1'),
        )
        x = x + (a @ attn['out_w'] + attn['out_b'])
        x = x + _mlp(_layer_norm(x, block['ln_2']), block['mlp'])
    x = _layer_norm(x[:, 0], params['ln_post'])
    return x @ params['proj']


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).transpose(1, 2)


def _sdpa(q, k, v) -> torch.Tensor:
    """Unmasked softmax attention on ``(B, h, N, d)`` → ``(B, N, h*d)``
    (``oadp_tpu``'s ``_sdpa``, for shapes its packed kernel refuses)."""
    b, h, m, d = q.shape
    logits = (q * (1.0 / math.sqrt(d))).float() @ k.float().transpose(-1, -2)
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
    bf16 rounds: the fused wiring (kernels 1 and 2) iff ``D % 128 == 0``
    and the crop batch ``B % 8 == 0``; else the split wiring (``:499-557``)
    with the QKV and out-projections as matmuls, the main stream through
    kernel 4 and the side row through kernel 5 (or, where ``D % 128 !=
    0``, the logits-concat softmax).

    Args:
        images: ``(B, H, W, 3)`` normalized crops.
        masks: ``(B, g, g)`` background masks, 1 = background.
    """
    x = _layer_norm(_embed_patches(images, params, config), params['ln_pre'])
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
                x = x + _mlp(_layer_norm(x, block['ln_2']), mlp)
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
