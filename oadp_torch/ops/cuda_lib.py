"""Build and load the hand-written CUDA kernels (``oadp_torch/csrc``).

The kernels are CUDA C++ for ``sm_90a`` with a plain C interface. At first
use, every ``csrc/*.cu`` is compiled with ``nvcc`` (one process per source,
all started together) and linked into one shared library under
``build/oadp_torch_kernels/`` in the checkout, named by a hash of the
sources and flags: an unchanged tree loads the library it built before, a
changed one builds anew. The library is loaded with ``ctypes``; nothing
here runs at import time, so the CPU-only tests import the package freely.
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
        subprocess.run(
            [nvcc, *NVCC_FLAGS, '-shared', *objects, '-o', str(tmp_so)],
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
                p, i, i, p, p, p, p, i, p, i, p, p, p,
            ]
            lib.oadp_ln_gemm.restype = i
            lib.oadp_attention.argtypes = [
                p, i, i, i, i, i, i, i, ctypes.c_float, p, i, p, i, p, p,
                i, p,
            ]
            lib.oadp_attention.restype = i
            lib.oadp_error_string.argtypes = [i]
            lib.oadp_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise when a kernel entry returned a nonzero ``cudaError_t``."""
    if code != 0:
        msg = library().oadp_error_string(code).decode()
        raise RuntimeError(f'{what}: CUDA error {code} ({msg})')
