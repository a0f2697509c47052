"""Classes of the port's CUDA kernels by name, and which launch counters
of the port count each class.

:func:`part` is a frozen copy of ``oadp_torch/profile_kernels.py:
_kernel_part``: the port's kernels (namespace ``oadp``) by family, the
products of ``ln_gemm``'s two schedules by epilogue (template argument 1:
0, 1 or 2), then PyTorch's library products, LayerNorm and elementwise
kernels.
"""

import re

#: the classes whose kernels are matrix products, whichever kernel runs them
PRODUCTS = ('ln_gemm', 'ln_gemm_gelu', 'ln_gemm_residual', 'cublas_gemm')
#: the classes of the attention kernels (the main stream's and the side row's)
ATTENTION = ('attention_kernel',)

#: class -> the entry points (``LAUNCHES`` keys of ``oadp_torch/ops``) that
#: launch one kernel of it each; ``unless``: counters whose launches may
#: also run the class, which leave it unchecked in that session
LAUNCH_FAMILIES = {
    'resize_crops_kernel': dict(counters=('resize_crops',)),
    'patch_rows_kernel': dict(counters=('patch_rows',)),
    'embed_ln_pre_kernel': dict(counters=('embed_ln_pre',)),
    'attention_kernel': dict(
        counters=('fused_surgery_layer', 'fused_mha_qkv', 'fused_side_attention'),
        unless=('fused_ln_qkv_attention',)),
    'greedy_nms_kernel': dict(counters=('greedy_nms',)),
}


def part(name: str) -> str:
    """The class of a kernel, by its (mangled or demangled) name."""
    if 'oadp' in name:
        gemm = re.search(r'(?:gemm|pingpong)_kernel(?:<\d+, (\d)|ILi\d+ELi(\d)E)', name)
        if gemm:
            return {'1': 'ln_gemm_gelu', '2': 'ln_gemm_residual'}.get(
                gemm.group(1) or gemm.group(2), 'ln_gemm')
        for kernel in ('resize_crops_kernel', 'patch_rows_kernel', 'embed_ln_pre_kernel',
                       'ln_qkv_attention_kernel', 'attention_kernel', 'layer_norm_kernel',
                       'greedy_nms_kernel'):
            if kernel in name:
                return kernel
        return 'oadp_other'
    low = name.lower()
    if any(k in low for k in ('nvjet', 'gemm', 'cutlass', 'xmma', 'cublas', 'sm90_')):
        return 'cublas_gemm'
    if 'layer_norm' in low:
        return 'torch_layer_norm'
    if 'elementwise' in low:
        return 'torch_elementwise'
    return 'other'
