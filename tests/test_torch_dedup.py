"""The port's ``duplicate_mask`` (``ops/seqops.py``) against the JAX
package's and against a dict of first occurrences: case and U folding, a
prefix that is no duplicate, equal words with unequal lengths, and random
words with ties."""

import jax.numpy as jnp
import numpy as np
import pytest

from cute_nucleotides_tpu.ops import oracle
from cute_nucleotides_tpu.ops import seqops as ref
from cute_nucleotides_tpu_torch import interop
from cute_nucleotides_tpu_torch.ops import seqops


def _rows(seqs, b5: bool = False):
    enc, per = (oracle.n_to_bits2_lut, 27) if b5 else (oracle.n_to_bits_lut, 32)
    lens = np.array([len(s) for s in seqs], np.int32)
    rows = np.zeros((len(seqs), 2 * max(1, -(-int(lens.max()) // per))), np.uint32)
    for i, s in enumerate(seqs):
        if s:
            v = np.ascontiguousarray(enc(np.frombuffer(s, np.uint8))).view(np.uint32)
            rows[i, : v.size] = v
    return rows, lens


def _mask(rows, lens):
    got = interop.to_numpy(seqops.duplicate_mask(interop.to_tensor(rows), interop.to_tensor(lens)))
    want = np.asarray(ref.duplicate_mask(jnp.asarray(rows), jnp.asarray(lens)))
    assert got.dtype == want.dtype == np.bool_ and np.array_equal(got, want)
    return got.tolist()


@pytest.mark.parametrize("b5", (False, True), ids=("2bit", "base5"))
def test_equals_reference_and_first_occurrence_dict(b5):
    rng = np.random.default_rng(7 + b5)
    pool = [rng.choice(list(b"ACGTN" if b5 else b"ACGT"), int(rng.integers(5, 60))).astype(np.uint8).tobytes()
            for _ in range(12)]
    seqs = [pool[int(rng.integers(0, len(pool)))] for _ in range(64)]
    seen, want = set(), []
    for s in seqs:
        want.append(s in seen)
        seen.add(s)
    assert _mask(*_rows(seqs, b5)) == want


def test_case_and_u_fold_and_a_prefix_is_not_a_duplicate():
    assert _mask(*_rows([b"ACGT", b"acgu", b"ACG", b"ACGT"])) == [False, True, False, True]


def test_length_distinguishes_padded_equals():
    assert _mask(*_rows([b"ACGTA", b"ACGT"])) == [False, False]
    assert _mask(*_rows([b"ACGTN", b"ACGT"], b5=True)) == [False, False]


def test_random_words_with_ties():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 3, (200, 5)).astype(np.uint32)
    rows[:, 2] |= np.uint32(0x80000000)  # the sign bit: only equality matters
    lens = rng.integers(0, 3, 200).astype(np.int32)
    got = _mask(rows, lens)
    keys = [(int(n), *r.tolist()) for n, r in zip(lens, rows)]
    assert got == [k in keys[:i] for i, k in enumerate(keys)]


def test_one_row():
    assert _mask(np.zeros((1, 2), np.uint32), np.zeros(1, np.int32)) == [False]
