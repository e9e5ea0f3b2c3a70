"""Build and bind the host C++ oracle (``codec.cpp``).

The port's counterpart of ``cute_nucleotides_tpu/native/__init__.py``, and
``codec.cpp`` here is a copy of that package's source.  The library is
compiled with the system ``g++`` on first use into the git-ignored
``cute_nucleotides_tpu_torch/build/``, named by a hash of the source and
the flags (never next to the source), so a checkout builds it once and an
edited source rebuilds it.  If it cannot build (no compiler), :func:`load`
returns None and :mod:`..ops.native` falls back to the NumPy oracle.

``codec.cpp`` lives here and not in ``csrc/``: ``ops/_build.py`` hands every
``csrc/*.cu`` to nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")

GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_size = ctypes.c_size_t
#: (argtypes, restype) of the functions the port calls
_SIGNATURES = {
    "cutenuc_n_to_bits": ([_u8p, _size, _u64p], None),
    "cutenuc_bits_to_n": ([_u64p, _size, _u8p], None),
    "cutenuc_n_to_bits2": ([_u8p, _size, _u64p], None),
    "cutenuc_bits_to_n2": ([_u64p, _size, _u8p], None),
    "cutenuc_find_invalid": ([_u8p, _size, ctypes.c_int], ctypes.c_longlong),
    "cutenuc_fill_rows": ([_u8p, _i64p, _i64p, _size, _u8p, _size, _size], None),
    "cutenuc_memcpy": ([_u8p, _size, _u8p], None),
    "cutenuc_depad_nt4": ([_u8p, _size, _u8p], None),
    "cutenuc_fastq_scan": ([_u8p, _size, _i64p, _i64p, _size, _i64p], ctypes.c_longlong),
    "cutenuc_edit_distance": ([_u8p, _size, _u8p, _size], ctypes.c_longlong),
    "cutenuc_best_match": ([_u8p, _size, _u8p, _size, _i64p, _i64p], None),
    "cutenuc_prefix_match": ([_u8p, _size, _u8p, _size, _i64p, _i64p], None),
}


def _target() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcutenuc-{h.hexdigest()[:16]}.so")


def _compile(target: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True, text=True)
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file


def load() -> ctypes.CDLL | None:
    """The host oracle library, built on first call, or None if it cannot
    build."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            target = _target()
            if not os.path.exists(target):
                _compile(target)
            lib = ctypes.CDLL(target)
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = str(e)
            return None
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return lib
