"""Device steps of the OAKE globals, blocks and objects pipelines (port
of ``oadp_tpu/oake/encoders.py``).

Each step is preprocessing (crop/resize/normalize, see
``ops/preprocess.py``) followed by the CLIP encoder and an L2 normalize
to fp16. A bf16 model on the card cuts its objects and globals crops with
one ``resize_crops`` kernel launch a step (``oadp_tpu``'s route by compute
dtype: the single-pass bf16 resize); an fp32 model, the CPU and the blocks
pyramid take the resize as matmuls. PyTorch runs eagerly, so a step
returns as soon as its work is queued on the device; the caller fetches
the embeddings one batch later, which overlaps device compute with host
work. Host inputs go through pinned memory and a ``non_blocking`` copy.

While a profiler session is open, each staging of host inputs records a
``step.stage`` span (with the page-locked blocks CUDA's host pool created
over it, on a card) and the objects step's kernel launches a
``step.launch`` span (``utils/tracing.py``).
"""

__all__ = ['ClipModel', 'load_clip', 'OakeSteps']

import dataclasses
import pathlib
from typing import Any

import numpy as np
import torch

from ..models import clip as C
from ..ops import preprocess as P
from ..utils import logger, tracing


@dataclasses.dataclass
class ClipModel:
    params: Any
    config: C.ViTConfig
    surgery_params: Any
    surgery_config: C.ViTConfig
    device: torch.device
    dtype: torch.dtype

    @property
    def grid(self) -> int:
        """ViT patch grid of the surgery model (mask resolution),
        reference ``oadp/oake/objects.py:281``."""
        return self.surgery_config.grid


def resolve_device(device: str | torch.device) -> torch.device:
    """The device a run asked for; a CUDA request without a CUDA device
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'model.device is cuda but torch sees no CUDA device; '
            "pass --override .model.device:'cpu' to run on the CPU"
        )
    return device


def load_clip(
    checkpoint: str | None = 'pretrained/clip/ViT-B-32.pt',
    dtype: str = 'float32',
    upsample: int = 2,
    vit: dict | None = None,
    device: str | torch.device = 'cuda',
) -> ClipModel:
    """Load CLIP ViT-B/32 weights (OpenAI state dict or TorchScript
    archive) and build the stock and surgery parameter sets on ``device``.

    A missing checkpoint gives random weights with a warning, drawn from
    a ``torch.Generator`` seeded with 0 (not ``oadp_tpu``'s draws). ``vit``
    overrides the encoder geometry (tests use scaled-down widths).
    """
    device = resolve_device(device)
    if device.type == 'cuda':
        # fp32 products must be full fp32: the fp32 resize is PIL-exact
        # and the fp32 encoder is compared with oadp_tpu's
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = C.ViTConfig(**(vit or {}))
    tdtype = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    state = None
    if checkpoint and pathlib.Path(checkpoint).exists():
        state = _load_torch_checkpoint(checkpoint)
    if state is not None:
        params = C.load_openai_state_dict(state)
    else:
        if checkpoint:
            logger.warning(
                'CLIP checkpoint %s not found; using random weights',
                checkpoint,
            )
        params = C.init_vit_params(torch.Generator().manual_seed(0), config)
    surgery_params, surgery_config = C.upsample_vit_params(
        params, config, upsample
    )

    def on_device(p):
        p = C.map_params(p, lambda t: t.to(device=device, dtype=tdtype))
        # the CUDA kernels' K-major weights and fp32 LayerNorms, made once
        return C.prepare_kernel_params(p) if device.type == 'cuda' else p

    return ClipModel(
        on_device(params), config, on_device(surgery_params), surgery_config,
        device, tdtype,
    )


def _load_torch_checkpoint(path: str) -> dict[str, torch.Tensor] | None:
    try:
        state = torch.load(path, map_location='cpu', weights_only=False)
        if hasattr(state, 'state_dict'):
            state = state.state_dict()
    except Exception:
        try:
            state = torch.jit.load(path, map_location='cpu').state_dict()
        except Exception:
            logger.exception('failed to load CLIP checkpoint %s', path)
            return None
    return {
        k: v.float() for k, v in state.items() if isinstance(v, torch.Tensor)
    }


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """fp32 normalize → fp16 output — the reference's
    ``F.normalize(e).half()`` (``oadp/oake/objects.py:330``)."""
    x = x.float()
    return (x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)).half()


def _pin_counts() -> dict[str, int]:
    """Page-locked blocks created so far to grow CUDA's host pool, and the
    microseconds spent creating them (``torch.cuda.host_memory_stats``);
    empty where this torch does not count them."""
    stats = torch.cuda.host_memory_stats()
    if 'num_host_alloc' not in stats:
        return {}
    return dict(pin_allocs=stats['num_host_alloc'],
                pin_alloc_us=stats['host_alloc_time.total'])


def _windows(levels: torch.Tensor, coords: torch.Tensor, size: int) -> torch.Tensor:
    """``levels[i, l, y:y + size, x:x + size]`` for each row ``(i, l, y, x)``
    of ``coords`` → ``(T, size, size, 3)``. Start indices are clamped into
    bounds as ``jax.lax.dynamic_slice`` clamps them, so the zero padding
    rows of ``coords`` give the top-left window of image 0's level 0."""
    b, n_levels, ph, pw, _ = levels.shape
    if ph < size or pw < size:
        raise ValueError(f'levels of {ph}x{pw} are smaller than a {size} block')
    i = coords[:, 0].clamp(0, b - 1)[:, None, None]
    lv = coords[:, 1].clamp(0, n_levels - 1)[:, None, None]
    r = torch.arange(size, device=levels.device)
    ys = (coords[:, 2].clamp(0, ph - size)[:, None] + r)[:, :, None]
    xs = (coords[:, 3].clamp(0, pw - size)[:, None] + r)[:, None, :]
    return levels[i, lv, ys, xs]


class OakeSteps:
    """Step functions of the pipelines for one model and pad size."""

    def __init__(self, model: ClipModel, pad_w: int = 640, pad_h: int = 640):
        self.model = model
        self.pad_w = pad_w
        self.pad_h = pad_h
        # bf16 encoders take the single-pass resize; fp32 keeps the
        # PIL-exact fp32 path (oadp_tpu's _compute_dtype)
        self._cdt = torch.bfloat16 if model.dtype == torch.bfloat16 else None

    def _to_device(self, x, dtype=None) -> torch.Tensor:
        """Host array, tensor, or a list of either (stacked: host arrays by
        numpy, on the calling thread alone) → tensor on the model's device
        (pinned staging, non-blocking copy)."""
        cuda = self.model.device.type == 'cuda'
        with tracing.span('step.stage', counters=_pin_counts if cuda else None):
            if isinstance(x, (list, tuple)):
                x = np.stack(x) if all(isinstance(a, np.ndarray) for a in x) else torch.stack([
                    a if isinstance(a, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(a)) for a in x
                ])
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            if dtype is not None:
                x = x.to(dtype)
            if cuda and x.device.type == 'cpu':
                x = x.pin_memory()
            return x.to(self.model.device, non_blocking=True)

    def _on_kernel(self, images: torch.Tensor, k_pad: int) -> bool:
        """Whether the crops take :func:`P.resize_crops`' kernel: a bf16 model
        with its images on the card, at a tap count the kernel takes
        (:func:`P.resize_crops_supported`)."""
        return (self._cdt is not None and images.device.type == 'cuda'
                and P.resize_crops_supported(k_pad))

    def _crops(self, images, meta, k_pad: int, k_own=None) -> torch.Tensor:
        """Source images and ``(G * B, 9)`` crop scalars → normalized ``(G *
        B, 224, 224, 3)`` crops, crop ``c`` cut from image ``c // B``: one
        image ``(PH, PW, 3)`` for every crop, or ``(G, PH, PW, 3)`` (``B =
        1``: a paired batch). ``k_own``: each image's own tap count, where
        the group's ``k_pad`` is larger (:func:`P.device_coeffs`). On the
        kernel, one launch for all of them."""
        if self._on_kernel(images, k_pad):
            return P.resize_crops(images, meta, k_pad, k_own=k_own)
        if images.dim() == 4 and images.shape[0] != meta.shape[0]:  # G chunks of B crops
            b = meta.shape[0] // images.shape[0]
            return torch.cat([
                self._crops(image, meta[i * b:(i + 1) * b], k_pad,
                            None if k_own is None else k_own[i:i + 1])
                for i, image in enumerate(images)])
        wx_w, wx_s, wy_w, wy_s = P.device_coeffs(
            meta, k_pad, k_own=P._own_per_crop(k_own, meta.shape[0], meta.device))
        crops = P.apply_resize_coeffs(
            images.float(), wx_w, wx_s, wy_w, wy_s, compute_dtype=self._cdt
        )
        return P.normalize_clip(crops, self.model.dtype)

    @torch.inference_mode()
    def globals_step(
        self,
        images,  # (B, PH, PW, 3) uint8, or a list of (PH, PW, 3)
        meta,  # (B, 9) per-image scalars
        k_pad: int,
    ) -> torch.Tensor:
        crops = self._crops(
            self._to_device(images), self._to_device(meta, torch.float32),
            k_pad,
        )
        emb = C.image_encoder(self.model.params, crops, self.model.config)
        return _l2_normalize(emb)

    @torch.inference_mode()
    def blocks_step(
        self,
        images,  # (B, PH, PW, 3) uint8, or a list of (PH, PW, 3)
        level_wx,  # (B, L, PW, PW) level k -> k+1 horizontal, or a list
        level_wy,  # (B, L, PH, PH), or a list
        whole_wx,  # (B, 224, PW), or a list
        whole_wy,  # (B, 224, PH), or a list
        coords,  # (T, 4) int32: (image, level, y, x), flat over the batch
    ) -> torch.Tensor:
        """→ ``(B + T, output_dim)`` fp16 embeddings: the B whole-image
        rows first, then the T flat block rows (``oadp_tpu``'s
        ``_blocks_fn``).

        Each image's pyramid is a chain of :func:`P.apply_resize_pair`
        calls with an fp32 carry, each level kept as uint8 (every level is
        ``round_u8``-ed, so the cast is lossless); the whole image is one
        more resize; each block is a 224 x 224 window of a level. Per-image
        arguments may be lists of host arrays or device tensors (the CLI
        keeps its per-size constants on the device)."""
        images = self._to_device(images)
        lwx, lwy, wwx, wwy = (
            self._to_device(a, torch.float32)
            for a in (level_wx, level_wy, whole_wx, whole_wy)
        )
        imgf = images.float()
        levels, carry = [images], imgf
        for k in range(lwx.shape[1]):
            carry = P.apply_resize_pair(carry, lwx[:, k], lwy[:, k],
                                        compute_dtype=self._cdt)
            levels.append(carry.to(torch.uint8))
        wholes = P.apply_resize_pair(imgf, wwx, wwy, compute_dtype=self._cdt)
        blocks = _windows(torch.stack(levels, 1), self._to_device(coords).long(),
                          wholes.shape[1])
        crops = P.normalize_clip(
            torch.cat([wholes, blocks.to(wholes.dtype)]), self.model.dtype
        )
        emb = C.image_encoder(self.model.params, crops, self.model.config)
        return _l2_normalize(emb)

    def _objects(self, crops, masks) -> torch.Tensor:
        emb = C.image_encoder_surgery(
            self.model.surgery_params, crops, masks, self.model.surgery_config
        )
        return _l2_normalize(emb)

    @torch.inference_mode()
    def objects_step(
        self,
        image,  # (PH, PW, 3) uint8
        meta,  # (B, 9) per-crop scalars (clip_transform_meta)
        masks,  # (B, grid, grid) 1 = background
        k_pad: int,
    ) -> torch.Tensor:
        crops = self._crops(
            self._to_device(image), self._to_device(meta, torch.float32),
            k_pad,
        )
        return self._objects(crops, self._to_device(masks))

    @torch.inference_mode()
    def objects_multi_step(
        self,
        images,  # list of (PH, PW, 3) uint8 source images
        img_idx,  # (G,) int: source image of each chunk
        metas,  # list of G (B, 9) per-crop scalar arrays
        masks,  # list of G (B, grid, grid) uint8 masks
        k_pad: int,
    ) -> torch.Tensor:
        """→ ``(G * B, output_dim)`` fp16 embeddings, chunk-major: crop
        chunks from several source images in one encoder batch."""
        images = self._to_device(images)
        metas = self._to_device(metas, torch.float32)
        idx = torch.as_tensor(np.asarray(img_idx, np.int64), device=images.device)
        crops = self._crops(images[idx], metas.reshape(-1, 9), k_pad)
        masks = self._to_device(masks)
        return self._objects(crops, masks.reshape(-1, *masks.shape[2:]))

    def packed_chunk_size(self, crop_rows: int) -> int:
        """Byte length of one packed chunk buffer (see
        :meth:`objects_packed_step`)."""
        g = self.model.grid
        return (
            self.pad_h * self.pad_w * 3
            + crop_rows * g * g
            + crop_rows * 9 * 4
        )

    @torch.inference_mode()
    def objects_packed_step(
        self,
        bufs,  # (G, packed_chunk_size(B)) uint8 host array (or list)
        crop_rows: int,  # B: crop rows per chunk
        k_pad: int,  # tap count (shared by the group)
        k_own=None,  # G ints: each chunk's own tap bucket (<= k_pad)
    ) -> torch.Tensor:
        """→ ``(G * B, output_dim)`` fp16 embeddings, chunk-major.

        Each chunk arrives as one flat uint8 buffer ``[image bytes | mask
        bytes | meta-float32 bytes]`` built by ``ObjectsPipeline.prepare``;
        the group is one host-to-device copy and the unpack is views. A
        chunk's crops keep the weights of its own tap bucket ``k_own``
        (``oadp_tpu`` runs each bucket as its own program)."""
        buf = self._to_device(bufs)  # (G, L) uint8
        with tracing.span('step.launch'):
            g = buf.shape[0]
            grid = self.model.grid
            n_img = self.pad_h * self.pad_w * 3
            n_mask = crop_rows * grid * grid
            images = buf[:, :n_img].reshape(g, self.pad_h, self.pad_w, 3)
            masks = buf[:, n_img:n_img + n_mask].reshape(
                g * crop_rows, grid, grid
            )
            metas = buf[:, n_img + n_mask:].contiguous().view(torch.float32)
            crops = self._crops(images, metas.reshape(g * crop_rows, 9), k_pad, k_own)
            return self._objects(crops, masks)
