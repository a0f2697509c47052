"""Native (C++) host-runtime kernels, built lazily with g++ (a copy of
``oadp_tpu/native/__init__.py``).

These kernels cover host-side hot loops that are otherwise Python-bound
(the reference outsources its equivalents to the pycocotools C
extension). Each ``{name}.cpp`` is compiled at first use into
``build/oadp_torch_native/`` in the checkout, named by a hash of its
source. Loading is best-effort: callers fall back to pure Python when no
compiler is available.
"""

__all__ = ['load_library', 'build_dir']

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

from ..utils import logger

_SRC_DIR = pathlib.Path(__file__).resolve().parent
_cache: dict[str, ctypes.CDLL | None] = {}

_p, _i = ctypes.c_void_p, ctypes.c_int
#: the C signature of each library's entry point
_SIGNATURES = {
    'cocoeval_match': ('match_pairs', [_p, _p, _p, _p, _i, _i, _i, _p, _p]),
}


def build_dir() -> pathlib.Path:
    return _SRC_DIR.parents[1] / 'build' / 'oadp_torch_native'


def load_library(name: str) -> ctypes.CDLL | None:
    """Compile-and-load ``{name}.cpp`` (cached by source hash)."""
    if name in _cache:
        return _cache[name]
    src = _SRC_DIR / f'{name}.cpp'
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out_dir = build_dir()
    so = out_dir / f'{name}-{tag}.so'
    try:
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            # built beside the target and renamed, so that processes that
            # build at once never load a half-written file
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                tmp_so = pathlib.Path(tmp) / so.name
                subprocess.run(
                    ['g++', '-O3', '-shared', '-fPIC', '-o', str(tmp_so),
                     str(src)],
                    check=True, capture_output=True,
                )
                os.replace(tmp_so, so)
        lib = ctypes.CDLL(str(so))
        fn, argtypes = _SIGNATURES[name]
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = None
    except (OSError, subprocess.CalledProcessError) as e:
        # no compiler, or the library does not load: fall back
        logger.warning('native %s unavailable (%s); using Python', name, e)
        lib = None
    _cache[name] = lib
    return lib
