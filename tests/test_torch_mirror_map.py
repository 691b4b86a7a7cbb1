"""The mirror map: every test file of the JAX package
(``tests/test_*.py`` without ``torch`` in its name) is named in the
docstring of at least one ``tests/test_torch_*.py``, the port's file that
mirrors it. A new JAX test file without its port mirror fails here.

The one exception is ``tests/test_bench_docs.py``: it checks the JAX
bench's documents (``docs/benchmarks.md`` against the bench's evidence),
which the port does not have; the port's benchmark is to come.
"""

import ast
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent

EXCEPTIONS = {"test_bench_docs.py"}

JAX_FILES = sorted(p.name for p in TESTS.glob("test_*.py")
                   if "torch" not in p.name)


def _docstrings():
    return {p.name: ast.get_docstring(ast.parse(p.read_text())) or ""
            for p in TESTS.glob("test_torch_*.py")
            if p.name != Path(__file__).name}


DOCS = _docstrings()


@pytest.mark.parametrize("name", [n for n in JAX_FILES
                                  if n not in EXCEPTIONS])
def test_jax_test_file_has_a_port_mirror(name):
    mirrors = [m for m, doc in DOCS.items() if name in doc]
    assert mirrors, f"no tests/test_torch_*.py docstring names {name}"


def test_exceptions_are_jax_test_files():
    assert EXCEPTIONS <= set(JAX_FILES)
    assert len(JAX_FILES) >= 27
