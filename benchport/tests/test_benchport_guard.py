"""The guard against JAX and the JAX package, and the reference's
independence of the measured package."""

import ast
import json
from pathlib import Path

import pytest

import run

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("loaded, found", [
    ({"torch", "kissabc_tpu_torch", "kissabc_tpu_torch.ops"}, []),
    ({"jax.numpy", "numpy"}, ["jax"]),
    ({"jaxlib.xla_client", "flax"}, ["flax", "jaxlib"]),
    ({"kissabc_tpu.core.smc", "kissabc_tpu_torch"}, ["kissabc_tpu"]),
    ({"jaxtyping", "kissabc_tpu_extra"}, []),
])
def test_forbidden_modules_compare_whole_names(loaded, found):
    assert run.forbidden_modules(loaded) == found


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__":
            yield ast.unparse(node.args[0])


@pytest.mark.parametrize("part", ["reference", "configs", "metrics",
                                  "kinds"])
def test_plain_parts_import_nothing_of_the_port_or_jax(part):
    for path in (BENCH / part).glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "kissabc_tpu",
                               "kissabc_tpu_torch"), (path, name)


def test_no_harness_file_imports_jax():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "kissabc_tpu"), (path, name)


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "gk-smc-1m", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_run_stops_where_jax_is_loaded(monkeypatch):
    import sys
    import torch

    from small import SECONDS, SMALL
    monkeypatch.setitem(sys.modules, "jax", object())
    over, traffic = SMALL["gk-smc-1m"]
    out = run.run("gk-smc-1m", 5, SECONDS, False, device=torch.device("cpu"),
                  overrides=over, traffic_overrides=traffic)
    assert out is None


def test_benchmark_json_names_every_file():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] != "setup_s":
            assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for c in bench["configs"]:
        assert (BENCH.parent / c["file"]).exists()
    for w in bench["workloads"]:
        traffic = BENCH / "traffic" / f"{w['traffic']}.json"
        kind = json.loads(traffic.read_text())["kind"]
        assert (BENCH / "kinds" / f"{kind}.py").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
