"""Device steps of the OAKE globals and objects pipelines (port of
``oadp_tpu/oake/encoders.py``).

Each step is preprocessing (crop/resize/normalize as matmuls, see
``ops/preprocess.py``) followed by the CLIP encoder and an L2 normalize
to fp16. PyTorch runs eagerly, so a step returns as soon as its work is
queued on the device; the caller fetches the embeddings one batch later,
which overlaps device compute with host work. Host inputs go through
pinned memory and a ``non_blocking`` copy.
"""

__all__ = ['ClipModel', 'load_clip', 'OakeSteps']

import dataclasses
import pathlib
from typing import Any

import numpy as np
import torch

from ..models import clip as C
from ..ops import preprocess as P
from ..utils import logger


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

    def cast(t):
        return t.to(device=device, dtype=tdtype)

    return ClipModel(
        C.map_params(params, cast), config,
        C.map_params(surgery_params, cast), surgery_config,
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
        """Host array, list of host arrays or tensor → tensor on the
        model's device (pinned staging, non-blocking copy)."""
        if isinstance(x, (list, tuple)):
            x = np.stack([np.asarray(a) for a in x])
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            x = x.to(dtype)
        if self.model.device.type == 'cuda' and x.device.type == 'cpu':
            x = x.pin_memory()
        return x.to(self.model.device, non_blocking=True)

    def _crops(self, image, meta, k_pad: int) -> torch.Tensor:
        """One source image (or a paired batch) and ``(B, 9)`` crop
        scalars → normalized ``(B, 224, 224, 3)`` crops."""
        wx_w, wx_s, wy_w, wy_s = P.device_coeffs(meta, k_pad)
        crops = P.apply_resize_coeffs(
            image.float(), wx_w, wx_s, wy_w, wy_s, compute_dtype=self._cdt
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
        crops = torch.cat([
            self._crops(images[int(i)], meta, k_pad)
            for i, meta in zip(img_idx, metas)
        ])
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
    ) -> torch.Tensor:
        """→ ``(G * B, output_dim)`` fp16 embeddings, chunk-major.

        Each chunk arrives as one flat uint8 buffer ``[image bytes | mask
        bytes | meta-float32 bytes]`` built by ``ObjectsPipeline.prepare``;
        the group is one host-to-device copy and the unpack is views."""
        buf = self._to_device(bufs)  # (G, L) uint8
        g = buf.shape[0]
        grid = self.model.grid
        n_img = self.pad_h * self.pad_w * 3
        n_mask = crop_rows * grid * grid
        images = buf[:, :n_img].reshape(g, self.pad_h, self.pad_w, 3)
        masks = buf[:, n_img:n_img + n_mask].reshape(
            g * crop_rows, grid, grid
        )
        metas = buf[:, n_img + n_mask:].contiguous().view(torch.float32)
        metas = metas.reshape(g, crop_rows, 9)
        crops = torch.cat([
            self._crops(images[i], metas[i], k_pad) for i in range(g)
        ])
        return self._objects(crops, masks)
