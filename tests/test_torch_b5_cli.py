"""The port's CLI with --codec base5 against the reference CLI: byte-identical
.nup and FASTA, --verify-stream exit codes, and the parity gate."""

import json

import numpy as np
import pytest

from cute_nucleotides_tpu import cli as ref_cli
from cute_nucleotides_tpu_torch import cli

ALPHABET_N = np.frombuffer(b"ACGTUNacgtun", np.uint8)


def _records(n=23, seed=21):
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 26, 27, 28, 53, 54, 55] + rng.integers(1, 400, n - 8).tolist()
    return [(b"rec%d desc" % i, rng.choice(ALPHABET_N, size=L).tobytes()) for i, L in enumerate(lengths)]


@pytest.fixture(params=["fa", "fq"])
def reads(request, tmp_path):
    path = tmp_path / f"reads.{request.param}"
    with open(path, "wb") as f:
        for name, seq in _records():
            if request.param == "fa":
                f.write(b">%s\n%s\n" % (name, seq))
            else:
                f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, b"I" * len(seq)))
    return path


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("batch", [0, 5])
@pytest.mark.parametrize("validate", [False, True])
def test_encode_nup_identical_to_reference(reads, tmp_path, batch, validate):
    flags = ["--codec", "base5", "--batch", str(batch)] + (["--validate"] if validate else [])
    assert cli.main(["encode", str(reads), str(tmp_path / "port.nup"), "--tier", "torch", *flags]) == 0
    assert ref_cli.main(["encode", str(reads), str(tmp_path / "ref.nup"), "--tier", "xla", *flags]) == 0
    assert _read(tmp_path / "port.nup") == _read(tmp_path / "ref.nup")


@pytest.mark.parametrize("batch", [0, 5])
@pytest.mark.parametrize("verify", [False, True])
def test_decode_fasta_identical_to_reference(reads, tmp_path, batch, verify):
    nup = tmp_path / "in.nup"
    assert ref_cli.main(["encode", str(reads), str(nup), "--codec", "base5", "--tier", "oracle"]) == 0
    flags = ["--batch", str(batch)]
    verify_flag = ["--verify-stream"] if verify else []  # a clean stream decodes the same either way
    port_fa = tmp_path / "port.fa"
    assert cli.main(["decode", str(nup), str(port_fa), "--tier", "torch", *flags, *verify_flag]) == 0
    assert ref_cli.main(["decode", str(nup), str(tmp_path / "ref.fa"), "--tier", "xla", *flags]) == 0
    assert _read(port_fa) == _read(tmp_path / "ref.fa")


def _corrupt_nup(tmp_path, word: int, bits: int):
    fa = tmp_path / "r.fa"
    fa.write_bytes(b">a\nACGTN\n>b two\n" + b"ACGTN" * 20 + b"\n>c\nGGG\n")
    nup, bad = tmp_path / "ok.nup", tmp_path / "bad.nup"
    assert cli.main(["encode", str(fa), str(nup), "--codec", "base5", "--tier", "oracle"]) == 0
    codec, entries = ref_cli.read_nup(str(nup))
    words = [w.copy() for _, _, w in entries]
    words[1][word] |= np.uint64(bits)
    ref_cli.write_nup(str(bad), [e[0] for e in entries], words, [e[1] for e in entries], codec)
    return nup, bad


@pytest.mark.parametrize("batch", [0, 2])
@pytest.mark.parametrize("word,bits", [(2, 0x7F << 14), (3, 1 << 63)])
def test_verify_stream_exit_codes(tmp_path, capsys, batch, word, bits):
    nup, bad = _corrupt_nup(tmp_path, word, bits)
    out = tmp_path / "out.fa"
    flags = ["--tier", "torch", "--batch", str(batch)]
    assert cli.main(["decode", str(nup), str(out), *flags, "--verify-stream"]) == 0
    assert cli.main(["decode", str(bad), str(tmp_path / "plain.fa"), *flags]) == 0  # no check asked
    capsys.readouterr()
    out.unlink()
    assert cli.main(["decode", str(bad), str(out), *flags, "--verify-stream"]) == 1
    assert capsys.readouterr().err.strip() == f"error: corrupt base-5 word {word} in record b two"
    assert not out.exists() and not (tmp_path / "out.fa.tmp").exists()
    assert ref_cli.main(["decode", str(bad), str(out), "--tier", "xla", "--batch", str(batch),
                         "--verify-stream"]) == 1


@pytest.mark.parametrize("batch", [0, 5])
def test_validate_allows_n_and_names_the_bad_record(tmp_path, capsys, batch):
    fa = tmp_path / "bad.fa"
    fa.write_bytes(b">ok\nACGTN\n>bad one\nACNXT\n")
    out = tmp_path / "bad.nup"
    rc = cli.main(["encode", str(fa), str(out), "--codec", "base5", "--tier", "torch", "--validate",
                   "--batch", str(batch)])
    assert rc == 1
    assert "at 3 in bad one" in capsys.readouterr().err
    assert not out.exists()


def test_parity_checks_both_codecs(capsys):
    assert cli.main(["parity", "--trials", "6", "--max-len", "200", "--tiers", "oracle,torch"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "parity": "PASS", "trials": 6, "failures": 0,
    }
