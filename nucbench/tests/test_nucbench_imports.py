"""Nothing under nucbench/ imports JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
reference imports nothing of the port."""

import ast
import os
import sys

from nucbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SIDE = {"jax", "jaxlib", "flax", "cute_nucleotides_tpu"}


def _top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = "") -> list[str]:
    out = []
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_no_module_imports_the_jax_side():
    sources = _sources()
    assert len(sources) > 20
    assert {p: _top_level_imports(p) & JAX_SIDE for p in sources if _top_level_imports(p) & JAX_SIDE} == {}


def test_the_reference_imports_nothing_of_the_port():
    sources = _sources("reference")
    assert sources
    allowed = {"__future__", "torch", "numpy"}
    assert {p: _top_level_imports(p) - allowed for p in sources if _top_level_imports(p) - allowed} == {}


def test_whole_top_level_names_decide(monkeypatch):
    monkeypatch.setitem(sys.modules, "cute_nucleotides_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "cute_nucleotides_tpu.ops_fake", object())
    monkeypatch.setitem(sys.modules, "jax.numpy_fake", object())
    assert harness.forbidden_loaded() == ["cute_nucleotides_tpu.ops_fake", "jax.numpy_fake"]


def test_the_name_check_sees_the_reference_package():
    assert "cute_nucleotides_tpu" in harness.FORBIDDEN and "jax" in harness.FORBIDDEN
