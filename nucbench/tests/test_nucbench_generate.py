"""The generator is deterministic from the seed, and makes what the traffic
files say."""

import numpy as np
import torch

from nucbench import generate

CPU = torch.device("cpu")


def test_reads_repeat_from_the_seed_and_differ_between_seeds():
    a = generate.reads(CPU, 2**31 + 11, (0, 0), 300, 150, 162, 0.001)
    b = generate.reads(CPU, 2**31 + 11, (0, 0), 300, 150, 162, 0.001)
    c = generate.reads(CPU, 2**31 + 12, (0, 0), 300, 150, 162, 0.001)
    d = generate.reads(CPU, 2**31 + 11, (0, 1), 300, 150, 162, 0.001)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_reads_alphabet_padding_and_n_share():
    x = generate.reads(CPU, 7, "t", 4000, 150, 162, 0.01)
    assert x.shape == (4000, 162) and x.dtype == torch.uint8
    assert set(torch.unique(x[:, :150]).tolist()) == set(b"ACGTN")
    assert bool((x[:, 150:] == ord("A")).all())
    share = float((x[:, :150] == ord("N")).float().mean())
    assert 0.008 < share < 0.012
    counts = [int((x[:, :150] == b).sum()) for b in b"ACGT"]
    assert max(counts) / min(counts) < 1.05


def test_edited_tails_are_seeded_and_within_bounds():
    adapter = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    t1, l1 = generate.edited_tails(np.random.default_rng(5), 2000, adapter, 10, 33, 3)
    t2, l2 = generate.edited_tails(np.random.default_rng(5), 2000, adapter, 10, 33, 3)
    assert np.array_equal(t1, t2) and np.array_equal(l1, l2)
    assert l1.min() >= 7 and l1.max() <= 36
    same = sum(t1[i, : l1[i]].tobytes() == adapter[: l1[i]] for i in range(2000))
    assert 300 < same < 1000  # a quarter of the tails has no edit
    assert set(np.unique(t1[np.arange(36)[None, :] < l1[:, None]]).tolist()) <= set(b"ACGT")


def test_planted_tails_end_each_read():
    x = generate.reads(CPU, 3, "p", 50, 150, 162, 0.0)
    tails = np.frombuffer(b"CCCCCCCCCCGGGG" + b"T" * 6, np.uint8).reshape(1, 20).repeat(3, 0)
    lens = np.array([10, 14, 20])
    generate.plant_tails(x, np.array([4, 9, 30]), tails, lens, 150)
    for row, n in zip((4, 9, 30), lens):
        assert x[row, 150 - n:150].numpy().tobytes() == tails[0, :n].tobytes()
    assert bool((x[:, 150:] == ord("A")).all())


def test_genome_is_seeded_aligned_and_its_guides_carry_the_pam():
    lengths = [5000, 3001, 777]
    w1, off = generate.genome_2bit(CPU, 99, lengths)
    w2, _ = generate.genome_2bit(CPU, 99, lengths)
    assert torch.equal(w1, w2) and off == [0, 316, 504]
    assert all(o % 4 == 0 for o in off)
    g1 = generate.guides(np.random.default_rng(1), w1, off, lengths, 40, 20, b"NGG", 0.5)
    g2 = generate.guides(np.random.default_rng(1), w1, off, lengths, 40, 20, b"NGG", 0.5)
    assert g1 == g2 and len(g1) == 40 and all(len(g) == 23 and g.endswith(b"NGG") for g in g1)
    texts = [bytes(b"ACTG"[v] for v in generate.genome_codes(w1, off, np.array([c]), np.array([0]), n)[0])
             for c, n in enumerate(lengths)]

    def at_a_site(spacer):
        for t in texts:
            p = t.find(spacer)
            while p >= 0:
                if t[p + 21: p + 23] == b"GG":
                    return True
                p = t.find(spacer, p + 1)
        return False

    assert sum(at_a_site(g[:20]) for g in g1) >= 20


def test_revcomp():
    assert generate.revcomp(b"ACGTNGG") == b"CCNACGT"
