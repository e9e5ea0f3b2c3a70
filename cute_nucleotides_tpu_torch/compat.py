"""Drop-in names of the reference crate's 13 functions.

Counterpart of ``cute_nucleotides_tpu/compat.py``: the same names,
signatures (bytes in, u64 words out, explicit decode length) and
bit-identical results.  Each name keeps a mechanism of its own; on a CUDA
card each runs its kernel, and without one the same variant runs in eager
PyTorch (``tier="auto"``):

==================  ===========================================================
reference name      this package
==================  ===========================================================
n_to_bits_lut       host C++ oracle
n_to_bits_pext      ``mxu``: in-thread bit-plane gather (multiply-mask planes)
n_to_bits_shift     ``shift``: log-depth shift-OR tree
n_to_bits_movemask  ``interleave``: even/odd code planes + fold
n_to_bits_mul       ``mul``: multiply-as-bit-shuffle
bits_to_n_lut       host C++ oracle
bits_to_n_shuffle   ``shuffle``: packed-LUT variable shift
bits_to_n_pdep      ``swar``: masked spread multiplies
bits_to_n_clmul     ``select``: arithmetic select tree
n_to_bits2_lut      host C++ oracle
n_to_bits2_pext     base-5 encode kernel (funnel-shift byte window per word)
bits_to_n2_lut      host C++ oracle
bits_to_n2_pdep     base-5 decode kernel (multiply-shift digit split)
==================  ===========================================================
"""

from __future__ import annotations

import numpy as np

from . import api
from .ops import native

__all__ = [
    "n_to_bits_lut", "n_to_bits_pext", "n_to_bits_shift",
    "n_to_bits_movemask", "n_to_bits_mul",
    "bits_to_n_lut", "bits_to_n_shuffle", "bits_to_n_pdep", "bits_to_n_clmul",
    "n_to_bits2_lut", "n_to_bits2_pext", "bits_to_n2_lut", "bits_to_n2_pdep",
]


def n_to_bits_lut(n) -> np.ndarray:
    return native.n_to_bits(n)


def n_to_bits_pext(n) -> np.ndarray:
    return api.n_to_bits(n, variant="mxu")


def n_to_bits_shift(n) -> np.ndarray:
    return api.n_to_bits(n, variant="shift")


def n_to_bits_movemask(n) -> np.ndarray:
    return api.n_to_bits(n, variant="interleave")


def n_to_bits_mul(n) -> np.ndarray:
    return api.n_to_bits(n, variant="mul")


def bits_to_n_lut(bits, length: int) -> np.ndarray:
    return native.bits_to_n(bits, length)


def bits_to_n_shuffle(bits, length: int) -> np.ndarray:
    return api.bits_to_n(bits, length, variant="shuffle")


def bits_to_n_pdep(bits, length: int) -> np.ndarray:
    return api.bits_to_n(bits, length, variant="swar")


def bits_to_n_clmul(bits, length: int) -> np.ndarray:
    return api.bits_to_n(bits, length, variant="select")


def n_to_bits2_lut(n) -> np.ndarray:
    return native.n_to_bits2(n)


def n_to_bits2_pext(n) -> np.ndarray:
    return api.n_to_bits2(n)


def bits_to_n2_lut(bits, length: int) -> np.ndarray:
    return native.bits_to_n2(bits, length)


def bits_to_n2_pdep(bits, length: int) -> np.ndarray:
    return api.bits_to_n2(bits, length)
