"""CLIP's ViT image tower (OpenAI CLIP, ``clip/model.py``) with OADP's
objects surgery (``oadp/oake/objects.py``: half-stride patch grid with the
positional embedding interpolated bicubically, and the side stream that
starts as the CLS token and, in every block, attends over the block's
normalised patches and itself with -100 on background patches), in plain
float32 PyTorch.

:func:`random_params` makes the benchmark's weights, which both the port
and this reference are handed: weights ``(in, out)``, LayerNorms as
``scale`` and ``bias``, in the layout of OpenAI's state dict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import exact


def _leaves(cfg: dict) -> list[tuple[tuple, tuple, str]]:
    d, p, f = cfg['width'], cfg['patch_size'], 4 * cfg['width']
    grid = cfg['image_size'] // p
    out = [(('conv1',), (d, 3, p, p), 'w'), (('class_embedding',), (d,), 'e'),
           (('positional_embedding',), (grid * grid + 1, d), 'e'),
           (('proj',), (d, cfg['output_dim']), 'e')]
    for ln in ('ln_pre', 'ln_post'):
        out += [((ln, 'scale'), (d,), 's'), ((ln, 'bias'), (d,), 'b')]
    for i in range(cfg['layers']):
        b = ('blocks', i)
        for ln in ('ln_1', 'ln_2'):
            out += [(b + (ln, 'scale'), (d,), 's'), (b + (ln, 'bias'), (d,), 'b')]
        out += [(b + ('attn', 'qkv_w'), (d, 3 * d), 'w'), (b + ('attn', 'qkv_b'), (3 * d,), 'b'),
                (b + ('attn', 'out_w'), (d, d), 'w'), (b + ('attn', 'out_b'), (d,), 'b'),
                (b + ('mlp', 'fc_w'), (d, f), 'w'), (b + ('mlp', 'fc_b'), (f,), 'b'),
                (b + ('mlp', 'proj_w'), (f, d), 'w'), (b + ('mlp', 'proj_b'), (d,), 'b')]
    return out


def random_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Weights drawn on ``device`` from ``seed`` in one call: products at
    fan-in^-1/2, embeddings and the projection at width^-1/2, biases at
    0.02, LayerNorm scales 1 + 0.1 N and biases 0.02 N; cast to ``dtype``."""
    leaves = _leaves(cfg)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    buf = torch.randn(total, generator=gen, device=device)
    tree: dict = {'blocks': [{} for _ in range(cfg['layers'])]}
    off = 0
    for path, shape, kind in leaves:
        n = math.prod(shape)
        z = buf[off:off + n].view(shape)
        off += n
        if kind == 'w':
            t = z * math.prod(shape[1:] if path == ('conv1',) else shape[:1]) ** -0.5
        elif kind == 'e':
            t = z * cfg['width'] ** -0.5
        elif kind == 's':
            t = 1.0 + 0.1 * z
        else:
            t = 0.02 * z
        node = tree
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(key, {})
        node[path[-1]] = t.to(dtype)
    return tree


def surgery_positions(params: dict, cfg: dict) -> torch.Tensor:
    """The positional embedding on the half-stride grid: the CLS row, then
    the patch rows interpolated bicubically (``F.interpolate``,
    ``align_corners=False``) in float64."""
    pe = params['positional_embedding'].double()
    g0 = cfg['image_size'] // cfg['patch_size']
    g = grid(cfg)
    patches = pe[1:].reshape(g0, g0, -1).permute(2, 0, 1)[None]
    up = F.interpolate(patches, size=(g, g), mode='bicubic', align_corners=False)
    return torch.cat([pe[:1], up[0].permute(1, 2, 0).reshape(g * g, -1)]).float()


def grid(cfg: dict) -> int:
    p, s = cfg['patch_size'], cfg['surgery_stride']
    return (cfg['image_size'] + 2 * ((p - 1) // 2) - p) // s + 1


def _ln(x, p):
    return F.layer_norm(x, x.shape[-1:], p['scale'].float(), p['bias'].float(), 1e-5)


def _linear(x, w, b, cast):
    return cast(x) @ cast(w.float()) + b.float()


def _heads(t, h):
    b, n, d = t.shape
    return t.reshape(b, n, h, d // h).transpose(1, 2)


def _attend(q, k, v, h, cast, bias=None):
    """Softmax attention of ``(B, M, D)`` queries over ``(B, N, D)`` keys."""
    q, k, v = (_heads(t, h) for t in (q, k, v))
    logits = cast(q) @ cast(k).transpose(-1, -2) / math.sqrt(q.shape[-1])
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    out = cast(torch.softmax(logits, -1)) @ cast(v)
    b, _, m, _ = out.shape
    return out.transpose(1, 2).reshape(b, m, -1)


def _mlp(x, p, cast):
    h = _linear(x, p['fc_w'], p['fc_b'], cast)
    return _linear(h * torch.sigmoid(1.702 * h), p['proj_w'], p['proj_b'], cast)


def surgery_encode(params: dict, pixels: torch.Tensor, background: torch.Tensor, cfg: dict,
                   positions: torch.Tensor, cast=exact) -> torch.Tensor:
    """``(B, 3, H, W)`` normalised crops and ``(B, g, g)`` background masks
    (True = background) -> ``(B, output_dim)`` float32 embeddings (not
    normalised)."""
    h, p, s = cfg['heads'], cfg['patch_size'], cfg['surgery_stride']
    x = F.conv2d(cast(pixels), cast(params['conv1'].float()), stride=s, padding=(p - 1) // 2)
    b = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    cls = params['class_embedding'].float().expand(b, 1, -1)
    x = cast(_ln(torch.cat([cls, x], 1) + positions, params['ln_pre']))
    y = x[:, 0:1]
    bias = torch.cat([background.reshape(b, -1).float() * -100.0,
                      torch.zeros((b, 1), device=x.device)], 1)
    blocks = params['blocks']
    for i, blk in enumerate(blocks):
        attn, last = blk['attn'], i == len(blocks) - 1
        qkv = _linear(_ln(x, blk['ln_1']), attn['qkv_w'], attn['qkv_b'], cast)
        q, k, v = qkv.chunk(3, -1)
        qy, ky, vy = _linear(_ln(y, blk['ln_1']), attn['qkv_w'], attn['qkv_b'], cast).chunk(3, -1)
        side = _attend(qy, torch.cat([k[:, 1:], ky], 1), torch.cat([v[:, 1:], vy], 1), h,
                       cast, bias)
        y = cast(y + _linear(side, attn['out_w'], attn['out_b'], cast))
        y = cast(y + _mlp(_ln(y, blk['ln_2']), blk['mlp'], cast))
        if not last:
            x = cast(x + _linear(_attend(q, k, v, h, cast), attn['out_w'], attn['out_b'], cast))
            x = cast(x + _mlp(_ln(x, blk['ln_2']), blk['mlp'], cast))
    return _linear(_ln(y[:, 0], params['ln_post']), params['proj'],
                   torch.zeros(params['proj'].shape[1], device=x.device), cast)

