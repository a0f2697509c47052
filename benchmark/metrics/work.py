"""Operations and bytes of each configuration's work, from its shapes.

A roofline counts the work the algorithm needs, whatever kernel does it:
every matrix product as ``2 M K N`` operations on its inputs read once and
its output written once (bf16, two bytes a value), and attention as its
two products per head on Q, K and V read once and the output written once.
"""

from __future__ import annotations

import dataclasses

from . import peaks

BF16 = 2


@dataclasses.dataclass(frozen=True)
class Vit:
    """A CLIP ViT image tower as a configuration file states it."""
    width: int
    layers: int
    heads: int
    patch_size: int
    image_size: int
    output_dim: int
    stride: int

    @classmethod
    def surgery(cls, config: dict) -> 'Vit':
        """The OAKE objects encoder: the half-stride patch grid."""
        return cls(config['width'], config['layers'], config['heads'], config['patch_size'],
                   config['image_size'], config['output_dim'], config['surgery_stride'])

    @property
    def grid(self) -> int:
        if self.stride == self.patch_size:
            return self.image_size // self.patch_size
        pad = (self.patch_size - 1) // 2
        return (self.image_size + 2 * pad - self.patch_size) // self.stride + 1

    @property
    def tokens(self) -> int:
        return self.grid * self.grid + 1


def product(m: int, k: int, n: int, residual: bool = False) -> tuple[float, float]:
    """Operations and bytes of ``(m, k) @ (k, n)``."""
    nbytes = BF16 * (m * k + k * n + m * n * (2 if residual else 1))
    return 2.0 * m * k * n, float(nbytes)


def surgery_products(v: Vit, crops: int) -> list[tuple[float, float]]:
    """Every matrix product of one objects dispatch of ``crops`` crops:
    the patch product; each layer's QKV, out-projection, fc and proj on
    the main stream (the last layer only K and V: its main output is
    discarded) and on the side row; ``ln_post``'s projection."""
    d, n, f = v.width, v.tokens, 4 * v.width
    rows, patches = crops * n, crops * (n - 1)
    out = [product(patches, 3 * v.patch_size ** 2, d)]
    for layer in range(v.layers):
        if layer < v.layers - 1:
            out += [product(rows, d, 3 * d), product(rows, d, d, True),
                    product(rows, d, f), product(rows, f, d, True)]
        else:
            out.append(product(rows, d, 2 * d))
        out += [product(crops, d, 3 * d), product(crops, d, d, True),
                product(crops, d, f), product(crops, f, d, True)]
    out.append(product(crops, d, v.output_dim))
    return out


def surgery_attention(v: Vit, crops: int) -> list[tuple[float, float]]:
    """Each layer's attention launch over ``crops`` crops: the main stream's
    self-attention (all but the last layer) and the side row's masked pool
    over the patches and itself, sharing one read of K and V."""
    d, n = v.width, v.tokens
    out = []
    for layer in range(v.layers):
        main = layer < v.layers - 1
        flops = 4.0 * n * n * d * main + 4.0 * n * d
        nbytes = (BF16 * n * d * (4 if main else 2)  # Q, K, V read, output written
                  + BF16 * 4 * d + 4 * n)  # the side's q, k, v and output; its fp32 bias
        out.append((crops * flops, crops * float(nbytes)))
    return out


def bound_s(work: list[tuple[float, float]]) -> float:
    """The least time of a list of launches, each bound on its own."""
    return sum(peaks.bound_s(f, b) for f, b in work)


def surgery_crop_flops(v: Vit) -> float:
    """Model operations of one crop of the objects encoder."""
    return sum(f for f, _ in surgery_products(v, 1) + surgery_attention(v, 1))

