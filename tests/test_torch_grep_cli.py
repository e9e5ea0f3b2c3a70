"""The port's ``grep`` against the reference CLI's, and the CLI's error
exits: the same stdout, stderr and exit code from ``python -m
cute_nucleotides_tpu grep`` and the port on the same ``.nup`` files."""

import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from cute_nucleotides_tpu import cli as ref_cli
from cute_nucleotides_tpu.ops import oracle
from cute_nucleotides_tpu_torch import cli

REPO = pathlib.Path(__file__).resolve().parents[1]

#: the reference's own grep fixtures (tests/test_cli.py): GATTACA at 4, its
#: reverse complement at 15, an N run at 24 in the base-5 one
FASTA = {
    "2bit": b">r1\nACGTGATTACAGGGGTGTAATCCC\n>r2\nAAAA\n",
    "base5": b">r1\nACGTGATTACAGGGGTGTAATCCCNNA\n>r2\nAANAA\n",
}
CASES = {
    "2bit": [("GATTACA", "--both"), ("GNTTANA", "--count"), ("GATTACA", "--both", "--batch", "2"),
             ("GNTTANA", "--count", "--batch", "8"), ("CCCCCCCCCC",), ("CCCCCCCCCC", "--batch", "4"),
             ("ACGX",), ("ACGX", "--batch", "2")],
    "base5": [("GATTACA", "--both"), ("NN", "--count"), ("G?TTA?A", "--count"), ("TG?AAT", "--both"),
              ("G?TTA?A", "--batch", "2"), ("ACGX",), ("NN", "--count", "--both", "--batch", "1")],
}


def _encode(tmp_path, fasta: bytes, codec: str, name: str = "x") -> str:
    fa, nup = tmp_path / f"{name}.fa", tmp_path / f"{name}.nup"
    fa.write_bytes(fasta)
    assert ref_cli.main(["encode", str(fa), str(nup), "--codec", codec, "--tier", "oracle"]) == 0
    return str(nup)


def _both_clis(capsys, argv):
    capsys.readouterr()
    rc = cli.main(argv)
    got = capsys.readouterr()
    ref_rc = ref_cli.main(argv)
    want = capsys.readouterr()
    return (rc, got.out, got.err), (ref_rc, want.out, want.err)


@pytest.mark.parametrize("codec,case", [(c, case) for c, cases in CASES.items() for case in cases],
                         ids=[f"{c}:{' '.join(case)}" for c, cases in CASES.items() for case in cases])
def test_grep_identical_to_reference(tmp_path, capsys, codec, case):
    nup = _encode(tmp_path, FASTA[codec], codec)
    got, want = _both_clis(capsys, ["grep", nup, *case])
    assert got == want
    assert got[0] == (1 if case[0] in ("CCCCCCCCCC", "ACGX") else 0)


def _random_fasta(codec: str) -> bytes:
    """Records across the word seams and the base-5 kernel threshold (14000
    nt = 1038 u32), with a 21-nt primer planted on both strands."""
    rng = np.random.default_rng(41)
    alpha = np.frombuffer(b"ACGTacgtu" if codec == "2bit" else b"ACGTNacgtn", np.uint8)
    primer = b"GATTACAGGCATTCCGAAGTC"
    rc = primer[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    out = []
    for i, n in enumerate((0, 20, 33, 700, 14000)):
        s = bytearray(rng.choice(alpha, n).tobytes())
        for p, q in ((1, primer), (n // 2, rc), (n - 21, primer)):
            if 0 <= p <= n - 21:
                s[p : p + 21] = q
        out.append(b">rec%d\n%s\n" % (i, bytes(s)))
    return b"".join(out)


@pytest.mark.parametrize("codec", ["2bit", "base5"])
@pytest.mark.parametrize("flags", [("--both",), ("--count", "--both"), ("--both", "--batch", "3")],
                         ids=["both", "count", "batch"])
def test_grep_random_records_identical_to_reference(tmp_path, capsys, codec, flags):
    nup = _encode(tmp_path, _random_fasta(codec), codec)
    pattern = "GATTACAGGCATTCCGAAGTC" if "--count" in flags else (
        "GANTACAGG" if codec == "2bit" else "GA?TACAGG")
    got, want = _both_clis(capsys, ["grep", nup, pattern, *flags])
    assert got == want and got[0] == 0
    assert got[1].count("\n") >= 5


# --- the CLI's error exits ------------------------------------------------------------

@pytest.mark.parametrize("command", [["decode", "{}", "{out}"], ["decode", "{}", "-", "--batch", "2"],
                                     ["grep", "{}", "ACGT"], ["grep", "{}", "ACGT", "--count"]])
@pytest.mark.parametrize("kind", ["missing", "not-nup", "truncated"])
def test_bad_input_files_exit_like_the_reference(tmp_path, capsys, command, kind):
    path = tmp_path / "in.nup"
    if kind == "not-nup":
        path.write_bytes(b"NOPE1234")
    elif kind == "truncated":
        good = _encode(tmp_path, FASTA["2bit"], "2bit", "good")
        path.write_bytes(pathlib.Path(good).read_bytes()[:-3])
    argv = [a.format(str(path), out=str(tmp_path / "out.fa")) for a in command]
    got, want = _both_clis(capsys, argv)
    assert got == want
    assert got[0] == 1 and got[2].startswith("error: ") and got[2].count("\n") == 1
    assert not (tmp_path / "out.fa").exists()


def test_grep_into_a_closed_pipe_exits_141():
    """`grep ... | head -1`: the reader closes the pipe after one line; the
    command ends with the SIGPIPE exit code and no traceback."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    with tempfile.TemporaryDirectory() as d:
        nup = os.path.join(d, "polya.nup")  # 200,000 nt of A: one hit per position
        ref_cli.write_nup(nup, [b"polyA"], [np.zeros(6250, np.uint64)], [200000], "2bit")
        proc = subprocess.Popen([sys.executable, "-m", "cute_nucleotides_tpu_torch", "grep", nup, "A"],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        first = proc.stdout.readline()
        proc.stdout.close()
        err = proc.stderr.read().decode()
        rc = proc.wait(timeout=300)
    assert first == b'{"record": "polyA", "pos": 0, "strand": "+"}\n'
    assert rc == 141, err
    assert "Traceback" not in err and "Exception" not in err


@pytest.mark.parametrize("batch", [4, 2])
def test_verify_stream_names_every_corrupt_record_of_a_batch(tmp_path, capsys, batch):
    fa = tmp_path / "r.fa"
    fa.write_bytes(b">a\nACGTN\n>b two\n" + b"ACGTN" * 20 + b"\n>c\nGGG\n>d\n" + b"NNNA" * 30 + b"\n")
    nup, bad = tmp_path / "ok.nup", tmp_path / "bad.nup"
    assert ref_cli.main(["encode", str(fa), str(nup), "--codec", "base5", "--tier", "oracle"]) == 0
    codec, entries = ref_cli.read_nup(str(nup))
    words = [w.copy() for _, _, w in entries]
    words[1][2] |= np.uint64(0x7F << 14)
    words[3][3] |= np.uint64(1 << 63)
    ref_cli.write_nup(str(bad), [e[0] for e in entries], words, [e[1] for e in entries], codec)
    argv = ["decode", str(bad), str(tmp_path / "out.fa"), "--batch", str(batch), "--verify-stream"]
    capsys.readouterr()
    assert cli.main([*argv, "--tier", "torch"]) == 1
    err = capsys.readouterr().err
    assert ref_cli.main([*argv, "--tier", "xla"]) == 1
    want = capsys.readouterr().err
    named = ["error: corrupt base-5 word 2 in record b two", "error: corrupt base-5 word 3 in record d"]
    # a batch of 4 holds both corrupt records; batches of 2 stop at the first
    assert err.splitlines() == (named if batch == 4 else named[:1])
    assert err == want
    assert not (tmp_path / "out.fa").exists()


def test_grep_on_a_device_without_kernels_reaches_the_kernel_wrappers(tmp_path, capsys, monkeypatch):
    """grep never runs the plain version of a search kernel in place of the
    kernel: given a device that is neither the CPU nor CUDA, the wrappers
    refuse it (one error line, exit 1) instead of computing."""
    from cute_nucleotides_tpu_torch import models

    monkeypatch.setattr(models, "resolve_device", lambda tier, device=None: models.torch.device("meta"))
    long_b5 = b">long\n" + b"ACGTN" * 3000 + b"\n"
    for codec, fasta in (("2bit", FASTA["2bit"]), ("base5", long_b5)):
        nup = _encode(tmp_path, fasta, codec, codec)
        capsys.readouterr()
        assert cli.main(["grep", nup, "GATTACA", "--both"]) == 1
        assert capsys.readouterr().err == "error: no kernel for device meta\n"


def test_oracle_words_round_trip_the_fixture(tmp_path):
    """The fixtures decode to what they claim (the hits above are real)."""
    nup = _encode(tmp_path, FASTA["base5"], "base5")
    _, entries = ref_cli.read_nup(nup)
    assert bytes(oracle.bits_to_n2_lut(entries[0][2], entries[0][1])) == b"ACGTGATTACAGGGGTGTAATCCCNNA"
