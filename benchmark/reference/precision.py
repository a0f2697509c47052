"""How the reference rounds the operands of its products: not at all
(float32), or, for the control, through fp8 (e4m3, a scale a tensor), the
precision below the configuration's bf16."""

import torch

FP8_MAX = 448.0


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale that maps its largest
    magnitude to the format's largest value, back in float32."""
    scale = FP8_MAX / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

