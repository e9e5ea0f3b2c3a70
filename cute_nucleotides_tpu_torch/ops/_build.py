"""Build ``csrc/*.cu`` with ``nvcc`` at first use and bind it with ctypes.

The library goes to ``cute_nucleotides_tpu_torch/build/`` (git-ignored),
named by a hash of the sources and the compiler flags, so a checkout builds
it once and an edited source rebuilds it -- the scheme of the reference's
host oracle (``cute_nucleotides_tpu/native/__init__.py``).  Each source
compiles in its own ``nvcc`` process, all started together, and one more
links them.  A failed build raises with nvcc's stderr; nothing falls back to
another implementation.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: every pointer and the stream are c_void_p: ctypes would cut a bare int
#: to 32 bits
_SIGNATURES = {
    "cn_encode_2bit": [_vp, _vp, _i64, _int, _vp],
    "cn_decode_2bit": [_vp, _vp, _i64, _int, _vp],
    "cn_encode_2bit_checked": [_vp, _vp, _vp, _i64, _i64, _int, _vp],
    "cn_encode_2bit_pext": [_vp, _vp, _vp, _i64, _i64, _vp],
    "cn_encode_b5": [_vp, _vp, _vp, _i64, _vp],
    "cn_decode_b5": [_vp, _vp, _vp, _i64, _int, _vp],
    "cn_encode_b5_planar": [_vp, _vp, _vp, _i64, _vp],
    "cn_decode_b5_planar": [_vp, _vp, _vp, _i64, _int, _vp],
    "cn_match_2bit": [_vp, _i64, _vp, _int, _int, _int, _int, _i64, _vp, _vp],
    "cn_match_b5": [_vp, _i64, _vp, _int, _i64, _vp, _vp],
    "cn_kmer_codes": [_vp, _vp, _vp, _i64, _i64, _int, _vp],
    "cn_kmer_codes_pair": [_vp, _vp, _vp, _vp, _vp, _i64, _i64, _int, _vp],
    "cn_hist_codes": [_vp, _i64, _vp, _vp],
    "cn_kmer_hashes_pair": [_vp, _i64, _i64, _i64, _i64, _i64, _int, _int, _vp, _vp],
    "cn_minimizer_bits": [_vp, _i64, _i64, _int, _int, _int, _vp, _vp],
    "cn_gc_b5": [_vp, _i64, _vp, _vp],
    "cn_sort_pairs_radix": [_vp, _vp, _vp, _vp, _vp, _i64, _vp, _vp, _i64, _vp],
    "cn_myers": [_vp, _i64, _int, _vp, _vp, _i64, _i64, _i64, _vp, _vp, _int, _int, _i64, _vp, _vp, _vp, _vp, _vp,
                 _vp],
    "cn_myers_plan": [_int, _i64, _int, _vp],
    "cn_myers_stream": [_vp, _int, _int, _vp, _i64, _i64, _i64, _i64, _int, _i64, _vp, _int, _vp],
    "cn_peq_b5": [_vp, _i64, _int, _vp, _i64, _int, _vp, _vp],
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the stderr of a failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))


def _compile(sources: list[str], target: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj] for src, obj in zip(sources, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; raises if it cannot build."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
        target = os.path.join(BUILD_DIR, f"libcn_kernels-{_digest(sources)}.so")
        if not os.path.exists(target):
            _compile(sources, target)
        lib = ctypes.CDLL(target)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
