"""Kernel #9, the fused tempered sweep of ``kissabc_tpu_torch/csrc/
tempered.cuh``, compiled for the host with ``g++`` against the emulation
in ``tests/host_cuda/cuda_runtime.h`` (one thread per CUDA thread),
through ``tests/host_cuda/tempered_main.cpp``.

- The shifts that the shared ``derive_shifts`` (``csrc/shifts.cuh``, the
  one copy that #6, #7 and #8 use) and its warp form
  ``derive_shifts_warp`` (#9: one modulo a lane, shuffles, every lane the
  same shifts) give from six raw words equal ``rot_shifts6``'s for h in
  {3, 4, 5, 7, 1000, 65536}.
- A sweep from the two halves' raw words (two launches, half B against
  the updated half A) agrees with the plain version ``half_plain`` fed
  the shifts ``rot_shifts6`` makes of the same words and the seed word,
  within the JAX golden tolerance (rtol 2e-4, atol 2e-5) on committed
  values, the commit masks equal but where the tempered MH log-ratio
  lies within 1e-4 of the accept draw (the emulation's ``logf``/``expf``
  and torch's differ by an ulp); uncommitted walkers keep their inputs
  bit for bit. Half B is held against the plain version run on the
  kernel's half A. So too on halves of one block and one walker, and of
  two blocks and one walker; the entry point refuses halves of fewer than
  3 walkers.

The emulation checks control flow, index arithmetic and bit coordinates;
the arithmetic on the card is held against the plain version by
chip_smoke.py. Skipped without a host C++ compiler.
"""

import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from host_cuda.build import HERE, build_program
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import fused_ais as FA

RTOL, ATOL, BORDER = 2e-4, 2e-5, 1e-4
H = 300              # walkers a half: 3 blocks of 128, the last partial


def _models():
    """(prior, loglike) per case: the conjugate normal (one leaf) and a
    mixed discrete prior (two leaves, the push rounds)."""
    prior, ll_conj, _, _ = models.conjugate_normal()

    def ll_mixed(theta):
        a, k = theta
        return -0.5 * torch.square(a - 1.2) - 0.5 * torch.square(k - 3.0)

    return {"conjugate": (prior, ll_conj),
            "mixed": (kt.Factored(kt.Normal(1.0, 1.0),
                                  kt.DiscreteUniform(1, 6)), ll_mixed)}


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """case -> the emulated program of that model's tempered unit."""
    roots = {}
    for case, (prior, ll) in _models().items():
        unit = kt.make_fused_tempered_sweep(prior, ll).unit
        roots[case] = tmp_path_factory.mktemp(f"tempered_{case}")
        (roots[case] / f"{case}.cpp").write_text(
            unit.source + f'\n#include "{HERE}/tempered_main.cpp"\n')
    with ThreadPoolExecutor(len(roots)) as pool:   # one g++ each, at once
        return dict(zip(roots, pool.map(
            lambda case: build_program(roots[case], None, f"{case}.cpp"),
            roots)))


@pytest.mark.parametrize("h", [3, 4, 5, 7, 1000, 65536])
def test_shared_derive_shifts_equal_rot_shifts6(programs, h):
    rng = np.random.default_rng(h)
    sets = [torch.as_tensor(rng.integers(0, 1 << 32, 6, dtype=np.int64))
            for _ in range(40)]
    sets += [torch.zeros(6, dtype=torch.int64),
             torch.full((6,), (1 << 32) - 1, dtype=torch.int64),
             torch.arange(6, dtype=torch.int64) * (h - 1)]
    args = [str(x) for w in sets for x in [h, *w.tolist()]]
    out = subprocess.run([str(programs["conjugate"]), "shifts", *args],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    got = [[int(x) for x in line.split()] for line in out.splitlines()]
    want = [FA.rot_shifts6(w, h).tolist() for w in sets]
    assert [g[:6] for g in got] == want      # derive_shifts
    assert [g[6:12] for g in got] == want    # derive_shifts_warp, lane 0
    assert all(g[12] == 1 for g in got)      # and every lane


def _state(case, sweep, h, seed):
    """Both halves' leaves, lp and ll from a seed, and 14 words."""
    rng = np.random.default_rng(seed)
    n = 2 * h
    if case == "conjugate":
        leaves = [torch.as_tensor(rng.normal(0, 1, n).astype(np.float32))]
    else:
        leaves = [torch.as_tensor(rng.normal(1, 1, n).astype(np.float32)),
                  torch.as_tensor((rng.integers(1, 7, n)
                                   + rng.uniform(-0.4, 0.4, n))
                                  .astype(np.float32))]
    pushed = sweep.pushed(leaves)
    lp = sweep.prior.logpdf_tree(pushed).to(torch.float32)
    ll = torch.as_tensor(sweep.loglike(pushed)).to(torch.float32).expand(n)
    words = torch.as_tensor(rng.integers(0, 1 << 32, 14, dtype=np.int64))
    return leaves, lp.contiguous(), ll.contiguous(), words


def _run(program, tmp_path, sweep, leaves, lp, ll, words, lam):
    """(the sweep's outputs, the error code): the leaves of half A, of
    half B, then lp A, ll A, lp B, ll B."""
    h = leaves[0].shape[0] // 2
    path = tmp_path / "sweep.in"
    with open(path, "wb") as f:
        f.write(np.int32(h).tobytes())
        for x in ([x[:h] for x in leaves] + [x[h:] for x in leaves]
                  + [lp[:h], ll[:h], lp[h:], ll[h:]]):
            f.write(x.numpy().tobytes())
        f.write(words.numpy().astype(np.int64).tobytes())
        f.write(np.float32(lam).tobytes())
        f.write(sweep.fconsts.astype(np.float32).tobytes())
        f.write(np.array([int(sweep.bits == "stub"), sweep._sb_rows(h)],
                         np.int32).tobytes())
    out = tmp_path / "sweep"
    line = subprocess.run([str(program), "sweep", str(path), str(out)],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout
    return (list(torch.as_tensor(np.fromfile(out, np.float32)).reshape(-1, h)),
            int(line))


def _compare(got, want, inputs, margin):
    """A half-update: the commit masks equal but within BORDER of the
    accept threshold; committed values within the golden tolerance;
    uncommitted outputs equal their inputs. Returns the commits."""
    def committed(outs):
        m = torch.zeros(inputs[0].shape, dtype=torch.bool)
        for o, x in zip(outs, inputs):
            m |= o != x
        return m
    gc, wc = committed(got), committed(want)
    differ = gc != wc
    assert bool((~differ | (margin.abs() < BORDER)).all())
    both = gc & wc
    for g, w, x in zip(got, want, inputs):
        np.testing.assert_allclose(g[both].numpy(), w[both].numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert torch.equal(g[~gc], x[~gc])
    return int(both.sum())


def _check_sweep(program, tmp_path, case, h, lam, bits, seed):
    """Runs one sweep of ``case`` over halves of ``h`` walkers from the
    words and holds each half against ``half_plain`` fed ``rot_shifts6``
    of the same words."""
    prior, ll_fn = _models()[case]
    sweep = kt.make_fused_tempered_sweep(prior, ll_fn, block=128,
                                         walker_tiles=2, bits=bits)
    leaves, lp, ll, words = _state(case, sweep, h, seed)
    got, err = _run(program, tmp_path, sweep, leaves, lp, ll, words, lam)
    assert err == 0
    k = len(leaves)
    ga = got[:k] + [got[2 * k], got[2 * k + 1]]
    gb = got[k:2 * k] + [got[2 * k + 2], got[2 * k + 3]]
    upd_a, upd_b = [x[:h] for x in leaves], [x[h:] for x in leaves]
    a = sweep.half_plain(upd_a, lp[:h], ll[:h], upd_b,
                         FA.rot_shifts6(words[:6], h), words[6:7], lam,
                         terms=True)
    commits = _compare(ga, list(a[0]) + [a[1], a[2]],
                       upd_a + [lp[:h], ll[:h]], a[3][1])
    b = sweep.half_plain(upd_b, lp[h:], ll[h:], ga[:k],
                         FA.rot_shifts6(words[7:13], h), words[13:], lam,
                         terms=True)
    commits += _compare(gb, list(b[0]) + [b[1], b[2]],
                        upd_b + [lp[h:], ll[h:]], b[3][1])
    assert commits > 0


@pytest.mark.parametrize("bits", ["hw", "stub"])
@pytest.mark.parametrize("lam", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("case", ["conjugate", "mixed"])
def test_sweep_from_words_equals_plain_fed_rot_shifts6(programs, tmp_path,
                                                       case, lam, bits):
    _check_sweep(programs[case], tmp_path, case, H, lam, bits, 7)


@pytest.mark.parametrize("bits", ["hw", "stub"])
@pytest.mark.parametrize("h", [129, 257])
def test_sweep_over_a_block_and_one_walker_equals_plain(programs, tmp_path,
                                                        h, bits):
    """Halves one walker past one and two blocks of 128: the last block
    holds a single walker and the other half's partners wrap."""
    _check_sweep(programs["mixed"], tmp_path, "mixed", h, 0.5, bits, 11)


def test_entry_points_refuse_halves_of_fewer_than_three(programs, tmp_path):
    """cudaErrorInvalidConfiguration (9), and nothing written."""
    prior, ll_fn = _models()["conjugate"]
    sweep = kt.make_fused_tempered_sweep(prior, ll_fn, block=128,
                                         walker_tiles=2)
    leaves, lp, ll, words = _state("conjugate", sweep, 2, 3)
    got, err = _run(programs["conjugate"], tmp_path, sweep, leaves, lp, ll,
                    words, 0.5)
    assert err == 9
    assert all(bool((x == -7.0).all()) for x in got)
