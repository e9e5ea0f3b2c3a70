"""The port's ``sketch`` against the reference CLI's: the same stdout,
stderr and exit code from ``cute_nucleotides_tpu.cli.main`` and the port's
``cli.main`` on the same files, mirroring the reference's sketch tests
(``tests/test_cli.py``): pairwise tables, FracMinHash mode and its
saturation warning, a base-5 ``.nup`` refused, k-mers touching N skipped,
empty records, a ``.nup`` against its FASTA source, and k = 32."""

import json

import numpy as np
import pytest

from cute_nucleotides_tpu import cli as ref_cli
from cute_nucleotides_tpu_torch import cli


def _seq(seed: int, n: int, alphabet: bytes = b"ACGT") -> bytes:
    return np.random.default_rng(seed).choice(np.frombuffer(alphabet, np.uint8), size=n).tobytes()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sketch")
    a, b, big = _seq(7, 400), _seq(8, 400), _seq(11, 600)
    paths = {}

    def write(name: str, body: bytes) -> None:
        paths[name] = str(d / name)
        with open(paths[name], "wb") as f:
            f.write(body)

    write("a.fa", b">a\n" + a + b"\n")
    write("a2.fa", b">a\n" + a + b"\n")
    write("b.fa", b">b\n" + b + b"\n")
    write("big.fa", b">g\n" + big + b"\n")
    write("sub.fa", b">s\n" + big[100:300] + b"\n")
    n_run = b"N" * 120
    write("an.fa", b">a\n" + _seq(5, 200) + n_run + b"\n")
    write("bn.fa", b">b\n" + _seq(6, 200) + n_run + b"\n")
    write("e.fa", b">empty\n\n>tiny\nACG\n>real\n" + b"ACGTAGGTCA" * 6 + b"\n")
    write("g.fa", b">g\n" + _seq(13, 800) + b"\n")
    write("n.fa", b">n\nACGTNNACGTACGTACGTACGTACGTACGT\n")
    reads = [(b"r%d" % i, _seq(20 + i, int(n), b"ACGTUNacgtun")) for i, n in
             enumerate(np.random.default_rng(3).integers(0, 300, 40))]
    write("reads.fq", b"".join(b"@%s\n%s\n+\n%s\n" % (n, s, b"I" * len(s)) for n, s in reads))
    for src, nup, codec in (("a.fa", "a.nup", "2bit"), ("e.fa", "e.nup", "2bit"), ("n.fa", "n5.nup", "base5")):
        paths[nup] = str(d / nup)
        assert ref_cli.main(["encode", paths[src], paths[nup], "--codec", codec, "--tier", "oracle"]) == 0
    return paths


def _both_clis(capsys, argv):
    capsys.readouterr()
    rc = cli.main(argv)
    got = capsys.readouterr()
    ref_rc = ref_cli.main(argv)
    want = capsys.readouterr()
    return (rc, got.out, got.err), (ref_rc, want.out, want.err)


CASES = {
    "pairwise": (["a.fa", "a2.fa", "b.fa"], ["-k", "11", "-s", "64", "--batch", "4"]),
    "nup equals fasta": (["a.nup", "a.fa"], ["-k", "11", "-s", "64", "--batch", "4"]),
    "default k 21": (["a.fa", "b.fa", "reads.fq"], []),
    "frac mode": (["sub.fa", "big.fa"], ["-k", "9", "-s", "1024", "--scale", "1"]),
    "frac scale 4": (["reads.fq", "big.fa", "sub.fa"], ["-k", "21", "-s", "4096", "--scale", "4"]),
    "skips N k-mers": (["an.fa", "bn.fa"], ["-k", "11", "-s", "512"]),
    "empty records": (["e.nup", "e.fa"], ["-k", "5", "-s", "32", "--batch", "1"]),
    "saturation warning": (["g.fa"], ["-k", "9", "-s", "64", "--scale", "1"]),
    "no canonical": (["reads.fq", "a.fa"], ["-k", "31", "-s", "200", "--no-canonical", "--batch", "7"]),
    "k 16 batch 3": (["reads.fq", "reads.fq"], ["-k", "16", "-s", "8192", "--batch", "3"]),
    "k 32": (["a.fa"], ["-k", "32"]),
    "base-5 nup": (["n5.nup"], ["-k", "5"]),
    "missing file": (["nope.fa"], ["-k", "5"]),
}


@pytest.mark.parametrize("case", CASES)
def test_sketch_identical_to_reference(files, capsys, case):
    inputs, opts = CASES[case]
    argv = ["sketch", *(files.get(p, p) for p in inputs), *opts]
    got, want = _both_clis(capsys, argv)
    assert got == want
    rc, out, err = got
    if case == "k 32":
        assert (rc, out, err) == (2, "", "error: k must be <= 31\n")
    elif case == "base-5 nup":
        assert (rc, out, err) == (1, "", f"error: {files['n5.nup']}: sketch requires a 2-bit stream\n")
    elif case == "missing file":
        assert rc == 1 and err.startswith("error: ")
    else:
        assert rc == 0
        table = json.loads(out)
        if case in ("pairwise", "nup equals fasta", "empty records"):
            assert table["pairs"][0]["jaccard"] == 1.0
        if case == "saturation warning":
            assert table["datasets"][0]["saturated"] is True and "saturated" in err
        if case == "skips N k-mers":
            assert table["pairs"][0]["jaccard"] < 0.05 and all(d["hashes"] < 400 for d in table["datasets"])


def test_sketch_tiers_agree(files, capsys):
    """The torch tier and the auto tier (the card where there is one) print
    alike."""
    out = []
    for tier in ("torch", "auto"):
        assert cli.main(["sketch", files["reads.fq"], files["a.fa"], "-k", "21", "--tier", tier]) == 0
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
