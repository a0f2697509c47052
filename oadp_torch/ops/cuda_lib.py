"""Build and load the hand-written CUDA kernels (``oadp_torch/csrc``).

The kernels are CUDA C++ for ``sm_90a`` with a plain C interface. At first
use, every ``csrc/*.cu`` is compiled with ``nvcc`` (one process per source,
all started together) and linked into one shared library under
``build/oadp_torch_kernels/`` in the checkout, named by a hash of the
sources and flags: an unchanged tree loads the library it built before, a
changed one builds anew. The library links the CUDA driver (``libcuda``,
for the TMA tensor maps of ``cuTensorMapEncodeTiled``) and is loaded with
``ctypes``; nothing here runs at import time, so the CPU-only tests import
the package freely.
"""

__all__ = ['library', 'check', 'build_dir']

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '-Xcompiler', '-fPIC',
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_dir() -> pathlib.Path:
    return CSRC.parents[1] / 'build' / 'oadp_torch_kernels'


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(str(pathlib.Path(CUDA_HOME) / 'bin' / 'nvcc'))
    candidates.append(shutil.which('nvcc') or '')
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _sources() -> tuple[list[pathlib.Path], str]:
    files = sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh'))
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for f in files:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    return [f for f in files if f.suffix == '.cu'], digest.hexdigest()[:16]


def _build(target: pathlib.Path, sources: list[pathlib.Path]) -> None:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        procs = []
        objects = []
        for src in sources:
            obj = pathlib.Path(tmp) / f'{src.stem}.o'
            objects.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-Xptxas', '-v', '-c', str(src),
                 '-o', str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        log = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f'== {src.name}\n{out}')
            if proc.returncode != 0:
                failed.append(src.name)
        (target.parent / 'build.log').write_text('\n'.join(log))
        if failed:
            raise RuntimeError(
                f'nvcc failed on {failed}:\n' + '\n'.join(log)
            )
        tmp_so = pathlib.Path(tmp) / target.name
        # the toolkit's stub resolves the driver symbols at link time; the
        # driver's own libcuda.so.1 is loaded at run time
        stubs = pathlib.Path(nvcc).resolve().parents[1] / 'lib64' / 'stubs'
        subprocess.run(
            [nvcc, *NVCC_FLAGS, '-shared', *objects, '-o', str(tmp_so),
             f'-L{stubs}', '-lcuda'],
            check=True,
        )
        os.replace(tmp_so, target)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            sources, key = _sources()
            target = build_dir() / f'liboadp_kernels_{key}.so'
            if not target.exists():
                _build(target, sources)
            lib = ctypes.CDLL(str(target))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.oadp_ln_gemm.argtypes = [
                i, p, p, p, p, p, i,  # K, gamma, beta, ln_out, Wt, bias, epilogue
                i, i, i,  # the plan: schedule, tile_n, units
                p, i, i, i, p, p,  # A0, M0, N0, col0_0, R0, C0
                p, i, i, i, p, p,  # A1, M1, N1, col0_1, R1, C1
                p,  # stream
            ]
            lib.oadp_ln_gemm.restype = i
            ll = ctypes.c_longlong
            lib.oadp_attention.argtypes = [
                i, i, i, ctypes.c_float,
                p, ll, i, p, ll, i, p, ll, i, p, ll, i,  # q, k, v, out
                p, i, p, i, p, i,  # qy, ky, vy
                p, p, i, p,  # bias, side_out, stream
            ]
            lib.oadp_attention.restype = i
            lib.oadp_long_attention.argtypes = [
                i, i, i, ctypes.c_float,  # B, N, heads, scale
                p, ll, i, p, ll, i, p, ll, i, p, ll, i,  # q, k, v, out
                p, i, p, i, p, i,  # qy, ky, vy
                p, p, i, p,  # bias, side_out, stream
            ]
            lib.oadp_long_attention.restype = i
            lib.oadp_ln_qkv_attention.argtypes = [
                i, i, i, ctypes.c_float,  # B, N, heads, scale
                p, p, p, p, p, p, p,  # x, gamma, beta, ln_out, Wt, bias, out
                p,  # stream
            ]
            lib.oadp_ln_qkv_attention.restype = i
            lib.oadp_greedy_nms.argtypes = [
                i, i, i, p, p, p,  # P, n, group, boxes, order, alive
                ctypes.c_float, i,  # thr, max_keep
                i, i, i,  # the plan: cluster, threads, tile
                p, p, p, p,  # keep, kept_ws, cycles, stream
            ]
            lib.oadp_greedy_nms.restype = i
            f = ctypes.c_float
            lib.oadp_resize_crops.argtypes = [
                p, ll, i, i, i, i,  # images, image stride, G, per image, PH, PW
                p, i, p, i,  # meta, k_pad, halves, out
                f, f, f, f, f, f,  # mean, std
                i, i, i, i, i,  # the layout: bands, band rows, ring rows, staging cap, smem
                p, p, p, p, p,  # dst, taps_w, taps_s, cycles, stream
            ]
            lib.oadp_resize_crops.restype = i
            lib.oadp_patch_rows.argtypes = [
                p, i, i, i, i, i, i, i, p, p,  # crops, B, H, W, P, S, pad, g, rows, stream
            ]
            lib.oadp_patch_rows.restype = i
            lib.oadp_embed_ln_pre.argtypes = [
                p, p, p, p, p, i, i, i, p, p,  # rows, cls, pos, gamma, beta, B, T, D, out, stream
            ]
            lib.oadp_embed_ln_pre.restype = i
            lib.oadp_error_string.argtypes = [i]
            lib.oadp_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise when a kernel entry returned a nonzero ``cudaError_t``."""
    if code != 0:
        msg = library().oadp_error_string(code).decode()
        raise RuntimeError(f'{what}: CUDA error {code} ({msg})')
