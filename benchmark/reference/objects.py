"""OAKE objects for one image, as OADP's ``oadp/oake/objects.py`` computes
them: proposals wider and taller than the minimum, each square-expanded
about its centre (ADAPTIVE: side ``sqrt(8 * area)``; CONSTANT: side 224)
and moved into the image where it fits, cut out with PIL (zero outside the image), through CLIP's
transform (``Resize(224)`` bicubic on the shorter side, ``CenterCrop(224)``,
``Normalize``), with its background mask at the crop's pixel resolution
resized to the patch grid (nearest); then the surgery encoder, L2-normalised.
"""

from __future__ import annotations

import numpy as np
import PIL.Image
import torch
import torch.nn.functional as F

from . import clip_vit
from .precision import exact

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def kept(proposals: np.ndarray, min_wh: float) -> np.ndarray:
    """The rows of ``(n, 5)`` proposals (box, objectness) kept: width and
    height above ``min_wh``."""
    wh = proposals[:, 2:4] - proposals[:, 0:2]
    return proposals[(wh[:, 0] > min_wh) & (wh[:, 1] > min_wh)]


def expand(boxes: np.ndarray, width: int, height: int, mode: str) -> np.ndarray:
    """Float32 square crop boxes of ``(n, 4)`` proposals."""
    boxes = boxes.astype(np.float32)
    centre = (boxes[:, :2] + boxes[:, 2:4]) / 2
    wh = boxes[:, 2:4] - boxes[:, :2]
    if mode == 'ADAPTIVE':
        side = np.sqrt(wh[:, 0] * wh[:, 1] * np.float32(8.0))[:, None]
    elif mode == 'CONSTANT':
        side = np.full((len(boxes), 1), 224.0, np.float32)
    else:
        raise ValueError(mode)
    lt, rb = centre - side / 2, centre + side / 2
    size = np.asarray([width, height], np.float32)
    shift = np.where(lt >= 0, 0, -lt)
    shift = np.where(rb <= size, shift, size - rb)
    shift = np.where(rb - lt <= size, shift, 0)
    return np.concatenate([lt + shift, rb + shift], 1).astype(np.float32)


def crop_pixels(image: PIL.Image.Image, crops: np.ndarray, out: int = 224) -> np.ndarray:
    """``(n, out, out, 3)`` uint8: each crop box cut by PIL (its corners
    rounded by ``round``), resized on its shorter side and centre-cut."""
    pixels = np.empty((len(crops), out, out, 3), np.uint8)
    for i, box in enumerate(crops):
        c = image.crop(tuple(float(v) for v in box))
        w, h = c.size
        size = (out, int(out * h / w)) if w <= h else (int(out * w / h), out)
        c = c.resize(size, PIL.Image.BICUBIC)
        left = int(round((size[0] - out) / 2.0))
        top = int(round((size[1] - out) / 2.0))
        pixels[i] = np.asarray(c.crop((left, top, left + out, top + out)))
    return pixels


def normalise(pixels: np.ndarray, device) -> torch.Tensor:
    """uint8 ``(n, H, W, 3)`` -> float32 ``(n, 3, H, W)`` CLIP inputs."""
    x = torch.from_numpy(pixels).to(device).permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=device)[:, None, None]
    return (x - mean) / std


def background(proposals: np.ndarray, crops: np.ndarray, grid: int, device) -> torch.Tensor:
    """``(n, grid, grid)`` bool, True where a patch is background: the
    proposal inside its crop, over the crop's pixels (``arange`` of its
    float size), nearest-resized to the grid."""
    out = torch.empty((len(crops), grid, grid), dtype=torch.bool, device=device)
    fg = torch.from_numpy(proposals[:, :4] - np.concatenate([crops[:, :2]] * 2, 1))
    for i, (x0, y0, x1, y1) in enumerate(crops.tolist()):
        xs = torch.arange(x1 - x0, device=device)
        ys = torch.arange(y1 - y0, device=device)
        f = fg[i].tolist()
        inside = (((f[1] <= ys) & (ys <= f[3]))[:, None]
                  & ((f[0] <= xs) & (xs <= f[2]))[None, :])
        mask = (~inside).float()[None, None]
        out[i] = F.interpolate(mask, size=(grid, grid), mode='nearest')[0, 0] > 0.5
    return out


@torch.no_grad()
def embed_image(image: PIL.Image.Image, proposals: np.ndarray, params: dict, cfg: dict,
                expand_mode: str, device, cast=exact, chunk: int = 250) -> dict:
    """The record OADP writes for one image: ``bboxes`` and ``objectness``
    (float16, the kept proposals) and ``embeddings`` (float32 here,
    L2-normalised) of each kept proposal."""
    allow = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        rows = kept(proposals, cfg['objects_min_proposal_wh'])
        crops = expand(rows[:, :4], image.width, image.height, expand_mode)
        positions = clip_vit.surgery_positions(params, cfg).to(device)
        g = clip_vit.grid(cfg)
        emb = []
        for s in range(0, len(rows), chunk):
            pixels = normalise(crop_pixels(image, crops[s:s + chunk], cfg['image_size']), device)
            bg = background(rows[s:s + chunk], crops[s:s + chunk], g, device)
            e = clip_vit.surgery_encode(params, pixels, bg, cfg, positions, cast)
            emb.append(e / torch.linalg.vector_norm(e, dim=-1, keepdim=True))
        return dict(bboxes=rows[:, :4].astype(np.float16),
                    objectness=rows[:, 4:5].astype(np.float16),
                    embeddings=torch.cat(emb).cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = allow
