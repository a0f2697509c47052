"""The operation and byte counters against hand counts at the
configuration's shapes."""

import json

import pytest

from benchmark import harness
from benchmark.metrics import kernel_parts, peaks, work

CFG = json.loads((harness.BENCH / 'configs' / 'clip-vit-b32.json').read_text())


def test_vit_b32_crop_operations_by_hand():
    # a 197-token ViT-B/32 crop: patch product 2*196*3072*768, a layer's
    # products 2*197*768*(2304 + 768 + 3072 + 3072) and attention 4*197^2*768,
    # the projection 2*768*512 (35.82 GFLOP with every layer whole); the
    # objects encoder's last layer projects only K and V of the main stream
    # and drops its attention, and the side row runs every layer
    surgery = work.Vit.surgery(CFG)
    assert surgery.grid == 14 and surgery.tokens == 197
    side = 12 * 2 * 768 * 9216 + 12 * 4 * 197 * 768
    hand = (2 * 196 * 3072 * 768 + 11 * (2 * 197 * 768 * 9216 + 4 * 197 ** 2 * 768)
            + 2 * 197 * 768 * 1536 + side + 2 * 768 * 512)
    assert work.surgery_crop_flops(surgery) == hand
    assert hand == pytest.approx(33.55e9, rel=1e-3)


def test_dispatch_bounds_by_hand():
    v = work.Vit.surgery(CFG)
    products = work.surgery_products(v, 2048)
    # patch product + 11 layers x 4 + last KV + 12 x 4 side + projection
    assert len(products) == 1 + 44 + 1 + 48 + 1
    fc = work.product(2048 * 197, 768, 3072)
    assert fc == (2 * 2048 * 197 * 768 * 3072, 2 * (2048 * 197 * 768 + 768 * 3072 + 2048 * 197 * 3072))
    # the out-projections (K = N = 768, a residual read) and the final
    # projection are bound by their bytes, every other product by its operations
    def excess(f, b):
        assert b / peaks.HBM_BYTES > f / peaks.BF16_FLOPS
        return b / peaks.HBM_BYTES - f / peaks.BF16_FLOPS

    flops = sum(f for f, _ in products)
    extra = (11 * excess(*work.product(2048 * 197, 768, 768, True))
             + 12 * excess(*work.product(2048, 768, 768, True))
             + excess(*work.product(2048, 768, 512)))
    assert work.bound_s(products) == pytest.approx(flops / peaks.BF16_FLOPS + extra)
    assert work.bound_s(products) * 1e3 == pytest.approx(67.58, abs=0.01)
    attention = work.surgery_attention(v, 2048)
    assert len(attention) == 12
    # a main layer reads Q, K and V and writes its output: 4 * 197 * 768 bf16 a crop
    f, b = attention[0]
    assert b == 2048 * (2 * 4 * 197 * 768 + 2 * 4 * 768 + 4 * 197)
    assert f == 2048 * (4 * 197 ** 2 * 768 + 4 * 197 * 768)
    assert peaks.bound_s(f, b) == b / peaks.HBM_BYTES  # bound by bytes
    assert work.bound_s(attention) * 1e3 == pytest.approx(8.56, abs=0.01)


@pytest.mark.parametrize('name, part', [
    ('void oadp::(anonymous namespace)::gemm_kernel<128, 1, 256>(Params)', 'ln_gemm_gelu'),
    ('_ZN4oadp12_GLOBAL__N_115pingpong_kernelILi256ELi2EEEvNS0_6ParamsE', 'ln_gemm_residual'),
    ('void oadp::(anonymous namespace)::gemm_kernel<64, 0, 128>(Params)', 'ln_gemm'),
    ('void oadp::(anonymous namespace)::attention_kernel<2>(Args)', 'attention_kernel'),
    ('void oadp::(anonymous namespace)::ln_qkv_attention_kernel(Args)', 'ln_qkv_attention_kernel'),
    ('void oadp::(anonymous namespace)::resize_crops_kernel(ResizeArgs)', 'resize_crops_kernel'),
    ('nvjet_tst_128x64_64x8_1x2_h_bz_TNN', 'cublas_gemm'),
    ('void at::native::vectorized_elementwise_kernel<4, ...>', 'torch_elementwise'),
])
def test_kernel_classes(name, part):
    assert kernel_parts.part(name) == part
    assert (part in kernel_parts.PRODUCTS) == part.startswith(('ln_gemm', 'cublas'))
