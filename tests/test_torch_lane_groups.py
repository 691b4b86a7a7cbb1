"""The lane-group kernels #6 (``fused_ais_sweep_kernel``), #10
(``fused_abcde_generation_kernel``) and #4 (``streaming_moment_cost_kernel``)
of ``kissabc_tpu_torch/csrc/generic.cuh``, compiled for the host with
``g++`` against the emulation in ``tests/host_cuda/cuda_runtime.h`` (one
thread per CUDA thread, the warp collectives as rendezvous that fail on a
lane outside the mask or a deadlock). Every launch geometry, walkers a
block from 1 to 512, threads from 32 to 512 and 1 to 16 lanes a walker
(#4: a group a walker, threads = walkers x lanes), must give the outputs
of one thread per walker (lanes = 1) bit for bit,
on Philox and stub bits, with ragged draw counts, on the flagship model
(2 statistics) and with 3 and 1 statistics; #4 also on 1000 draws and on
a count of walkers that no block divides, and it writes nothing past n.
#6 takes the half's raw words and derives its shifts in the kernel: its
outputs agree with the plain version fed the shifts ``rot_shifts6``
makes of the same words (the golden tolerance, as
tests/test_torch_ais_compaction.py holds #7). The emulation checks the
kernels' control flow and index arithmetic; their arithmetic on the card
is held against the plain versions by chip_smoke.py. The units are built
with every lane count (``lane_groups.with_all_lanes``); one built as the
wrappers build it must take lanes 1 and 4 with the same bits and refuse
the others. Skipped without a host C++ compiler.
"""

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from host_cuda.build import emulated
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import fused_ais as FA
from kissabc_tpu_torch.ops import lane_groups as LG

HOST = Path(__file__).parent / "host_cuda"
GEOMETRIES = [(64, 64, 1), (64, 64, 2), (64, 64, 4), (64, 128, 8),
              (128, 64, 16), (32, 256, 4), (200, 32, 2), (100, 96, 4),
              (512, 128, 8), (5, 32, 16), (7, 64, 8), (3, 32, 1)]
# kernel #4's (a group of lanes a walker: threads = walkers x lanes): the
# defaults (128 on 128 with 1 lane, 8 on 32 and 128 on 512 with 4), 2 to
# 512 walkers a block, 32 to 512 threads, 1 to 16 lanes
COST_GEOMETRIES = [(128, 128, 1), (8, 32, 4), (128, 512, 4), (32, 32, 1),
                   (2, 32, 16), (4, 64, 16), (24, 96, 4), (4, 32, 8),
                   (8, 64, 8), (32, 64, 2), (48, 96, 2), (256, 512, 2),
                   (64, 512, 8), (512, 512, 1), (32, 512, 16), (16, 64, 4),
                   (96, 96, 1), (256, 256, 1)]


def _model(stats):
    prior, draw, reduce_cost = models.flagship()
    if stats == 3:
        return prior, draw, (lambda th, m: m[0] + m[1] + m[2]), dict(
            stats=[lambda x, t=t: (x < t).to(torch.float32)
                   for t in (1.95, 2.0, 2.05)])
    if stats == 1:
        return prior, draw, (lambda th, m: torch.abs(m[0] - 2.0)), dict(
            nmoments=1)
    return prior, draw, reduce_cost, {}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """kind, statistics -> the emulated program's executable (every
    lane count; statistics "default": 2, the lanes of the wrappers' unit)."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation")
    root = tmp_path_factory.mktemp("lane_groups")
    csrc = Path(kt.__file__).parent / "csrc"
    for f in csrc.glob("*.cuh"):
        (root / f.name).write_text(emulated(f.read_text()))
    shutil.copy(HOST / "cuda_runtime.h", root)
    procs, exes = {}, {}
    for kind, stats in [(k, s) for k in ("abcde", "ais", "cost")
                        for s in (2, 3, 1)] + [("abcde", "default"),
                                               ("cost", "default")]:
        prior, draw, rc, kw = _model(2 if stats == "default" else stats)
        if kind == "abcde":
            unit = kt.make_fused_abcde_generation(prior, draw, rc,
                                                  gamma=1.19, **kw).unit
        elif kind == "cost":
            unit = kt.make_streaming_moment_cost(draw, rc, **kw).unit(2)
        else:
            unit = kt.make_fused_ais_sweep(prior, draw, rc, scale=0.5,
                                           **kw).unit
        if stats != "default":
            unit = LG.with_all_lanes(unit)
        src = root / f"{kind}{stats}.cpp"
        src.write_text(unit.source + f'\n#include "{HOST}/'
                       'lane_groups_main.cpp"\n')
        exes[kind, stats] = root / f"{kind}{stats}"
        procs[kind, stats] = subprocess.Popen(
            ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-pthread",
             "-w", "-I", str(root), str(src), "-o", str(exes[kind, stats])],
            stderr=subprocess.PIPE, text=True)
    for key, p in procs.items():
        _, err = p.communicate()
        assert p.returncode == 0, f"g++ failed on {key}:\n{err}"
    return exes


def _run(exe, n, ndraws, chunk, stub, geometries, env=None):
    args = [str(x) for g in geometries for x in g]
    out = subprocess.run([str(exe), str(n), str(ndraws), str(chunk),
                          str(stub), *args], capture_output=True, text=True,
                         timeout=600, check=True,
                         env=env and {**os.environ, **env}).stdout
    return [line.split() for line in out.splitlines()]


@pytest.mark.parametrize("kind", ["abcde", "ais"])
@pytest.mark.parametrize("stub,ndraws,chunk", [(0, 130, 32), (1, 130, 32),
                                               (0, 77, 512), (1, 1, 512)])
def test_every_geometry_gives_the_bits_of_one_thread_per_walker(
        built, kind, stub, ndraws, chunk):
    rows = _run(built[kind, 2], 200, ndraws, chunk, stub, GEOMETRIES)
    assert len(rows) == len(GEOMETRIES)
    assert all(r[3] == "0" for r in rows)           # launched
    assert {r[4] for r in rows} == {rows[0][4]}     # the same bits
    assert int(rows[0][5]) > 0                      # some walkers commit


@pytest.mark.parametrize("kind", ["abcde", "ais"])
@pytest.mark.parametrize("stats", [3, 1])
def test_other_statistic_counts(built, kind, stats):
    """3 statistics: 6 accumulators, so with 2 or 4 lanes a lane owns
    several; 1 statistic: 2 accumulators, so most lanes own none."""
    rows = _run(built[kind, stats], 200, 130, 32, 1, GEOMETRIES[:8])
    assert all(r[3] == "0" for r in rows)
    assert {r[4] for r in rows} == {rows[0][4]}


def test_entry_points_refuse_what_the_kernel_cannot_take(built):
    """cudaErrorInvalidConfiguration (9), and nothing written."""
    rows = _run(built["abcde", 2], 64, 10, 512, 0,
                [(64, 48, 4), (0, 64, 4), (4097, 64, 4), (64, 64, 3),
                 (64, 64, 32), (64, 1024, 1)])
    assert [r[3] for r in rows] == ["9"] * 6
    assert {r[4] for r in rows} == {rows[0][4]}


def test_the_wrappers_unit_has_lanes_1_and_4(built):
    """Built as the wrappers build it, the unit takes lanes 1 and 4 with
    the bits of the unit of every lane count, and refuses 2, 8 and 16
    (cudaErrorInvalidConfiguration, 9)."""
    geometries = [(64, 64, 1), (32, 256, 4), (64, 64, 2), (64, 128, 8),
                  (128, 64, 16)]
    rows = _run(built["abcde", "default"], 200, 130, 32, 1, geometries)
    assert [r[3] for r in rows] == ["0", "0", "9", "9", "9"]
    every = _run(built["abcde", 2], 200, 130, 32, 1, geometries[:2])
    assert {r[4] for r in rows[:2]} == {r[4] for r in every} == {
        every[0][4]}


@pytest.mark.parametrize("stub,ndraws,chunk", [(0, 130, 32), (1, 130, 32),
                                               (0, 77, 512), (1, 1, 512),
                                               (0, 1000, 32), (1, 1000, 512),
                                               (1, 77, 32), (0, 1, 32)])
def test_cost_every_geometry_gives_the_bits_of_one_thread_per_walker(
        built, stub, ndraws, chunk):
    """Kernel #4 over 203 walkers (no block size divides it): every
    geometry the bits of the first (one thread per walker), every moment
    of every walker written and nothing past n (rows of ld = n + 5)."""
    rows = _run(built["cost", 2], 203, ndraws, chunk, stub, COST_GEOMETRIES)
    assert len(rows) == len(COST_GEOMETRIES)
    assert all(r[3] == "0" for r in rows)
    assert {r[4] for r in rows} == {rows[0][4]}
    assert all(r[5] == str(2 * 203) for r in rows)


@pytest.mark.parametrize("stats", [3, 1])
def test_cost_other_statistic_counts(built, stats):
    rows = _run(built["cost", stats], 203, 130, 32, 1, COST_GEOMETRIES)
    assert all(r[3] == "0" for r in rows)
    assert {r[4] for r in rows} == {rows[0][4]}
    assert all(r[5] == str(stats * 203) for r in rows)


def test_cost_entry_point_refuses_what_the_kernel_cannot_take(built):
    """cudaErrorInvalidConfiguration (9), and nothing written (threads
    other than walkers x lanes too); the unit built as the wrapper builds
    it takes lanes 1 and 4 with the bits of the unit of every lane count
    and refuses 2, 8 and 16."""
    rows = _run(built["cost", 2], 64, 10, 512, 0,
                [(12, 48, 4), (0, 64, 4), (4097, 64, 4), (16, 48, 3),
                 (1, 32, 32), (1024, 1024, 1), (64, 128, 1), (128, 64, 1),
                 (8, 64, 4)])
    assert [r[3] for r in rows] == ["9"] * 9
    assert [r[5] for r in rows] == ["0"] * 9
    geometries = [(128, 128, 1), (16, 64, 4), (32, 64, 2), (8, 64, 8),
                  (8, 128, 16)]
    rows = _run(built["cost", "default"], 203, 130, 32, 1, geometries)
    assert [r[3] for r in rows] == ["0", "0", "9", "9", "9"]
    every = _run(built["cost", 2], 203, 130, 32, 1, geometries[:2])
    assert {r[4] for r in rows[:2]} == {r[4] for r in every} == {
        every[0][4]}


@pytest.mark.parametrize("bits", ["hw", "stub"])
def test_ais_half_from_words_matches_the_plain_version(built, tmp_path,
                                                       bits):
    """#6 on the half's seven words {5, 77, 100, 3, 40, 65, 2024} (the
    kernel derives the shifts) against ``half_plain`` fed
    ``rot_shifts6`` of the same words and the seed word, on the inputs
    the emulated program makes (n = 200, halves of 100): the commit masks
    equal but within 1e-4 of the accept threshold, committed values
    within rtol 2e-4, atol 2e-5, uncommitted outputs equal their inputs
    bit for bit."""
    n, h, ndraws, chunk = 200, 100, 130, 32
    dump = tmp_path / "ais.bin"
    rows = _run(built["ais", 2], n, ndraws, chunk, int(bits == "stub"),
                [(64, 64, 4)], env={"KT_DUMP": str(dump)})
    assert rows[0][3] == "0"
    data = torch.as_tensor(np.fromfile(dump, np.float32))
    th = list(data[:2 * n].reshape(2, n))
    lp, ll = data[2 * n:3 * n], data[3 * n:4 * n]
    got = list(data[4 * n:].reshape(4, h))
    prior, draw, rc = models.flagship()
    sw = kt.make_fused_ais_sweep(prior, draw, rc, scale=0.5, ndraws=ndraws,
                                 chunk=chunk, bits=bits)
    words = torch.tensor([5, 77, 100, 3, 40, 65, 2024])
    upd = [x[:h] for x in th]
    want = sw.half_plain(upd, lp[:h], ll[:h], [x[h:] for x in th],
                         FA.rot_shifts6(words[:6], h), words[6:],
                         terms=True)
    inputs = upd + [lp[:h], ll[:h]]
    outs = list(want[0]) + [want[1], want[2]]
    gc = torch.zeros(h, dtype=torch.bool)
    wc = torch.zeros(h, dtype=torch.bool)
    for g, w, x in zip(got, outs, inputs):
        gc |= g != x
        wc |= w != x
    assert bool(((gc == wc) | (want[3][1].abs() < 1e-4)).all())
    both = gc & wc
    assert int(both.sum()) > 0
    for g, w, x in zip(got, outs, inputs):
        np.testing.assert_allclose(g[both].numpy(), w[both].numpy(),
                                   rtol=2e-4, atol=2e-5)
        assert torch.equal(g[~gc], x[~gc])
