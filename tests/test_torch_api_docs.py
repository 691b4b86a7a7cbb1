"""The API-doc drift guard of ``tests/test_api_docs.py`` for
kissabc_tpu_torch: every ``### `name(signature)` `` header of
``docs/api_torch.md`` matches ``inspect.signature`` of the port's export
(names, order, kwarg defaults), every sampler and kernel factory of the
port has its header, and the density models' parameters are named in
their section. The parsing rules are the JAX test's.
"""

import inspect
from pathlib import Path

import pytest
from test_api_docs import (FORMULA_DEFAULTS, HEADER_RE, _norm_default,
                           _runtime_default, _split_toplevel)

import kissabc_tpu_torch as kt
from torch_threads import one_torch_thread  # noqa: F401

API_MD = Path(__file__).resolve().parent.parent / "docs" / "api_torch.md"

SAMPLERS = ("sample", "sample_raw", "smc", "smc_stepped", "tsmc", "ABCDE",
            "pfilter", "abc_rejection")
FACTORIES = tuple(n for n in kt.__all__ if n.startswith("make_")) + (
    "shard_batched_cost", "host_cost")


def _doc_headers():
    headers = []
    for line in API_MD.read_text().splitlines():
        m = HEADER_RE.match(line.strip())
        if m:
            headers.append((m.group(1), m.group(2)))
    return headers


DOC_HEADERS = _doc_headers()


def test_headers_found():
    names = [n for n, _ in DOC_HEADERS]
    for required in SAMPLERS + FACTORIES:
        assert required in names, (
            f"docs/api_torch.md lacks the {required} header")
    assert len(names) == len(set(names)), "duplicate API headers"
    assert len(FACTORIES) >= 14


@pytest.mark.parametrize("name,docsig", DOC_HEADERS,
                         ids=[n for n, _ in DOC_HEADERS])
def test_doc_signature_matches_runtime(name, docsig):
    fn = getattr(kt, name, None)
    assert fn is not None, f"docs/api_torch.md documents {name}, not exported"
    real = inspect.signature(fn)

    doc_pos, doc_kw, seen_star = [], {}, False
    for entry in _split_toplevel(docsig):
        if entry == "*":
            seen_star = True
            continue
        if "=" in entry:
            k, v = entry.split("=", 1)
            doc_kw[k.strip()] = v.strip()
        elif seen_star:
            doc_kw[entry] = None
        else:
            doc_pos.append(entry)

    real_pos = [p.name for p in real.parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty]
    real_pos += ["*" + p.name for p in real.parameters.values()
                 if p.kind == p.VAR_POSITIONAL]
    real_kw = {p.name: p for p in real.parameters.values()
               if p.kind == p.KEYWORD_ONLY
               or (p.kind == p.POSITIONAL_OR_KEYWORD
                   and p.default is not p.empty)}

    assert doc_pos == real_pos, (
        f"{name}: doc positional args {doc_pos} != runtime {real_pos}")
    assert set(doc_kw) == set(real_kw), (
        f"{name}: doc kwargs {sorted(doc_kw)} != runtime "
        f"{sorted(real_kw)} (missing in doc: "
        f"{sorted(set(real_kw) - set(doc_kw))}; stale in doc: "
        f"{sorted(set(doc_kw) - set(real_kw))})")

    for k, doc_val in doc_kw.items():
        if doc_val is None:
            continue
        if FORMULA_DEFAULTS.get(k) == doc_val.replace(" ", ""):
            assert real_kw[k].default is None, (
                f"{name}.{k}: doc shows the derived formula, runtime "
                "default must be the None sentinel")
            continue
        assert _norm_default(doc_val) == _runtime_default(real_kw[k]), (
            f"{name}.{k}: doc default {doc_val!r} != runtime "
            f"{real_kw[k].default!r}")


def test_density_models_params_documented():
    text = API_MD.read_text()
    section = text.split("## Density models")[1].split("\n## ")[0]
    for cls in (kt.ApproxPosterior, kt.ApproxKernelizedPosterior,
                kt.CommonLogDensity):
        for p in inspect.signature(cls).parameters.values():
            if p.name == "self":
                continue
            assert p.name in section, (
                f"{cls.__name__} param {p.name!r} undocumented in the "
                "Density models section")
