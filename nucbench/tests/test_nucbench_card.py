"""On a card: each one-card cell at its own size, a short window, correct;
and its control, not correct.  Skips without a card
(``python -m pytest nucbench/tests -m card`` on the card)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ["reads150-b5.codec", "reads150-b5.adapter-scan", "grch38-2bit.guide-search"]


def _cli(name, seed, control):
    p = subprocess.run([sys.executable, "-m", "nucbench", "--workload", name, "--seed", str(seed), "--seconds", "2",
                        "--trace", "0", "--control", str(control)], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_and_its_control_on_the_card(card, name):
    r = _cli(name, 2**32 + 17, 0)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert _cli(name, 2**32 + 18, 1)["correct"] is False
