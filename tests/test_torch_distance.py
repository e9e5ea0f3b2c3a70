"""The port's ``ops/distance.py`` against the JAX package's on the CPU, at
tolerance 0: the packed and byte Hamming distances and the two all-pairs
forms, with padded and ragged shapes and chunks that do not divide the
length.  Inputs come from numpy seeds and pass between the packages as
arrays."""

import numpy as np
import pytest
import torch

from cute_nucleotides_tpu.ops import distance as ref
from cute_nucleotides_tpu_torch.ops import distance

ALPHABET = np.frombuffer(b"ACGTUacgtu", np.uint8)


def _same(port: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert port.dtype == torch.int32 and port.device.type == "cpu"
    assert np.array_equal(port.numpy(), want)


@pytest.mark.parametrize("shape", ((1,), (7,), (3, 5), (2, 3, 33), (4, 0)))
def test_hamming_packed(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    a = rng.integers(0, 2**32, shape, dtype=np.uint32)
    b = a.copy()
    flip = rng.random(shape) < 0.5
    b[flip] ^= rng.integers(1, 2**32, int(flip.sum()), dtype=np.uint32)
    _same(distance.hamming_packed(torch.from_numpy(a), torch.from_numpy(b)), ref.hamming_packed(a, b))
    # every bit of one word, and the all-ones word against zero
    one = np.uint32(1) << np.arange(32, dtype=np.uint32)
    zero = np.zeros(32, np.uint32)
    got = distance.hamming_packed(torch.from_numpy(one.reshape(32, 1)), torch.from_numpy(zero.reshape(32, 1)))
    _same(got, ref.hamming_packed(one.reshape(32, 1), zero.reshape(32, 1)))
    full = np.full((1, 3), 0xFFFFFFFF, np.uint32)
    _same(distance.hamming_packed(torch.from_numpy(full), torch.zeros((1, 3), dtype=torch.uint32)),
          ref.hamming_packed(full, np.zeros((1, 3), np.uint32)))


@pytest.mark.parametrize("shape", ((33,), (4, 31), (2, 3, 27), (3, 0)))
def test_hamming_seqs_every_byte(shape):
    rng = np.random.default_rng(shape[-1])
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = rng.integers(0, 256, shape, dtype=np.uint8)
    _same(distance.hamming_seqs(torch.from_numpy(a), torch.from_numpy(b)), ref.hamming_seqs(a, b))
    every = np.arange(256, dtype=np.uint8)[None]
    up = (every & 0xDF)[None][0]
    _same(distance.hamming_seqs(torch.from_numpy(every), torch.from_numpy(up)), ref.hamming_seqs(every, up))


@pytest.mark.parametrize("B, L, chunk", ((1, 7, 2048), (5, 33, 8), (17, 100, 7), (30, 64, 32), (3, 4, 4)))
def test_pairwise_hamming(B, L, chunk):
    rng = np.random.default_rng(B * 1000 + L)
    reads = rng.choice(ALPHABET, (B, L))
    if B > 2 and L:
        reads[1] = reads[0]  # a duplicate pair: distance 0
    got = distance.pairwise_hamming(torch.from_numpy(reads), chunk=chunk)
    _same(got, ref.pairwise_hamming(reads, chunk=chunk))
    assert torch.equal(got, got.T) and not got.diagonal().any()


@pytest.mark.parametrize("B, W, chunk", ((1, 1, 2048), (5, 3, 20), (24, 4, 16), (9, 7, 100)))
def test_pairwise_hamming_packed(B, W, chunk):
    rng = np.random.default_rng(B * 100 + W)
    words = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
    _same(distance.pairwise_hamming_packed(torch.from_numpy(words), chunk=chunk),
          ref.pairwise_hamming_packed(words, chunk=chunk))
