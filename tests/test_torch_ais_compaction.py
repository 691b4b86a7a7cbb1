"""The flagship AIS sweeps #7 (``kt_fused_ais_half``) and #8
(``kt_fused_ais_full``) of ``kissabc_tpu_torch/csrc/ais.cu``, compiled for
the host with ``g++`` against the emulation in
``tests/host_cuda/cuda_runtime.h`` (one thread per CUDA thread, the warp
collectives as rendezvous that fail on a lane outside the mask or a
deadlock, and for #8's cooperative launch a grid barrier that hands the
turn from block to block), through ``tests/host_cuda/ais_main.cpp``.

- The shifts the kernels derive from six raw words equal
  ``rot_shifts6``'s (the JAX package's ``_rot_shifts6`` rule) for h in
  {3, 4, 5, 7, 1000, 65536}.
- Every launch geometry (256, 512 and 1024 walkers a block among others,
  32 to 512 threads, a half of 1100 walkers that no block size divides,
  and for #8 grids smaller than the ranges a half has) gives the outputs of
  one thread per walker bit for bit, on Philox and stub bits, with ragged
  draw counts.
- One thread per walker agrees with the plain versions
  ``FlagshipAIS.half_plain``/``full_plain`` fed the shifts that
  ``rot_shifts6`` makes of the same words, within the JAX golden tolerance
  (rtol 2e-4, atol 2e-5) on committed values, the commit masks equal but
  where the MH log-ratio lies within 1e-4 of the accept draw; uncommitted
  walkers keep their inputs bit for bit.

The emulation checks the kernels' control flow, index arithmetic and bit
coordinates; their arithmetic on the card is held against the plain
versions by chip_smoke.py. Skipped without a host C++ compiler.
"""

import subprocess

import numpy as np
import pytest
import torch

from host_cuda.build import build_program
from kissabc_tpu_torch.ops import fused_ais as FA
from torch_threads import one_torch_thread  # noqa: F401

H = 1100             # walkers a half: no block size divides it
RTOL, ATOL, BORDER = 2e-4, 2e-5, 1e-4
FL = dict(scale=0.1, target_mu=2.0, target_sd=0.04, sd_weight=50.0,
          a_stretch=3.0, mu_lo=1.0, mu_hi=3.0, sg_sigma=0.05, sg_lo=0.0,
          sg_hi=100.0, block=128)
# (walkers, threads); the first is the default at h = 65536
GEOMETRIES = [(512, 512), (512, 256), (256, 256), (256, 32), (1024, 512),
              (1024, 64), (512, 128), (256, 512), (37, 64), (100, 96)]


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    """The emulated program's executable."""
    return build_program(tmp_path_factory.mktemp("ais_compaction"),
                         "ais.cu", "ais_main.cpp")


def _words(rng, count):
    return torch.as_tensor(rng.integers(0, 1 << 32, count, dtype=np.int64))


def _start(seed):
    """mu ~ U(1, 3), sigma ~ U(0.01, 0.1), their prior logpdf and
    loglikelihoods in [-30, -1] (tests/test_torch_fused_ais.py), and the
    sweep's 13 words."""
    rng = np.random.default_rng(seed)
    n = 2 * H
    mu = rng.uniform(1, 3, n).astype(np.float32)
    sg = rng.uniform(0.01, 0.1, n).astype(np.float32)
    lp = (-np.log(2.0) - 0.5 * np.log(2 * np.pi * 0.05 ** 2)
          - sg ** 2 / (2 * 0.05 ** 2) - np.log(0.5)).astype(np.float32)
    ll = rng.uniform(-30, -1, n).astype(np.float32)
    return [torch.as_tensor(x) for x in (mu, sg, lp, ll)], _words(rng, 13)


def _run(program, tmp_path, kind, model, ins, words, sms, geometries):
    """(one thread per walker's outputs, [(error code, outputs)] per
    geometry): four float32 arrays each."""
    path = tmp_path / f"{kind}.in"
    with open(path, "wb") as f:
        f.write(np.int32(2 * H).tobytes())
        for x in ins:
            f.write(x.numpy().tobytes())
        f.write(words.numpy().astype(np.int64).tobytes())
        f.write(model.fconsts.tobytes())
        f.write(model.iconsts.tobytes())
    out = tmp_path / kind
    args = [str(x) for g in geometries for x in g]
    lines = subprocess.run([str(program), kind, str(path), str(out),
                            str(sms), *args], capture_output=True, text=True,
                           timeout=600, check=True).stdout.splitlines()

    def read(suffix):
        return torch.as_tensor(np.fromfile(f"{out}.{suffix}", np.float32)
                               ).reshape(4, -1)

    return read("ref"), [(int(line.split()[2]), read(k))
                         for k, line in enumerate(lines)]


@pytest.mark.parametrize("h", [3, 4, 5, 7, 1000, 65536])
def test_in_kernel_shifts_equal_rot_shifts6(program, h):
    rng = np.random.default_rng(h)
    sets = [_words(rng, 6) for _ in range(40)]
    sets += [torch.zeros(6, dtype=torch.int64),
             torch.full((6,), (1 << 32) - 1, dtype=torch.int64),
             torch.arange(6, dtype=torch.int64) * (h - 1)]
    args = [str(x) for w in sets for x in [h, *w.tolist()]]
    out = subprocess.run([str(program), "shifts", *args], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    got = [[int(x) for x in line.split()] for line in out.splitlines()]
    assert got == [FA.rot_shifts6(w, h).tolist() for w in sets]


def _model(bits, ndraws, chunk):
    return FA.FlagshipAIS(ndraws=ndraws, chunk=chunk, bits=bits, **FL)


@pytest.mark.parametrize("kind", ["half", "full"])
@pytest.mark.parametrize("bits,ndraws,chunk", [("hw", 130, 32),
                                               ("stub", 130, 32),
                                               ("hw", 77, 512),
                                               ("stub", 1, 512)])
def test_every_geometry_gives_the_bits_of_one_thread_per_walker(
        program, tmp_path, kind, bits, ndraws, chunk):
    ins, words = _start(1)
    model = _model(bits, ndraws, chunk)
    # #8 on a grid of 2 blocks strides over the ranges; on 64, one a block
    for sms in ((2, 64) if kind == "full" else (1,)):
        ref, runs = _run(program, tmp_path, kind, model, ins, words, sms,
                         GEOMETRIES)
        for (err, got), geo in zip(runs, GEOMETRIES):
            assert err == 0, geo
            assert torch.equal(got.view(torch.int32),
                               ref.view(torch.int32)), (geo, sms)
    if ndraws > 1:   # one draw's sd is 0: no proposal comes near to commit
        upd = torch.stack(ins)[:, :ref.shape[1]]
        assert bool((ref[0] != upd[0]).any())        # some walkers commit


@pytest.mark.parametrize("kind", ["half", "full"])
@pytest.mark.parametrize("bits", ["hw", "stub"])
def test_one_thread_per_walker_matches_the_plain_version(
        program, tmp_path, kind, bits):
    ins, words = _start(2)
    model = _model(bits, 200, 64)
    ref, _ = _run(program, tmp_path, kind, model, ins, words, 4, [])
    if kind == "half":
        want = model.half_plain(*(x[:H] for x in ins), ins[0][H:],
                                ins[1][H:], FA.rot_shifts6(words[:6], H),
                                words[6:7])
        inputs = [x[:H] for x in ins]
    else:
        shifts = torch.cat([FA.rot_shifts6(words[:6], H),
                            FA.rot_shifts6(words[6:12], H)])
        want = model.full_plain(*ins, shifts, words[12:])
        inputs = ins
    got = list(ref)

    def committed(outs):
        return torch.stack([o != x for o, x in zip(outs, inputs)]).any(0)

    gc, wc = committed(got), committed(want[:4])
    differ = gc != wc
    assert not bool((differ & (want[5].abs() >= BORDER)).any())
    both = gc & wc
    assert int(both.sum()) > 0
    for g, w, x in zip(got, want[:4], inputs):
        torch.testing.assert_close(g[both], w[both], rtol=RTOL, atol=ATOL)
        assert torch.equal(g[~gc], x[~gc])


@pytest.mark.parametrize("kind", ["half", "full"])
def test_entry_points_refuse_what_the_kernels_cannot_take(program, tmp_path,
                                                          kind):
    """cudaErrorInvalidConfiguration (9), and nothing written; the
    Python wrappers refuse the same geometries."""
    ins, words = _start(3)
    bad = [(256, 48), (0, 64), (1025, 64), (256, 1024), (256, 0)]
    _, runs = _run(program, tmp_path, kind, _model("hw", 10, 512), ins,
                   words, 4, bad)
    assert [err for err, _ in runs] == [9] * len(bad)
    assert all(bool((out == -7.0).all()) for _, out in runs)
    for walkers, threads in bad:
        with pytest.raises(ValueError):
            FA.check_geometry(H, walkers, threads)


def test_the_default_geometry():
    """One block of 512 walkers on 512 threads an SM at h = 65536 on the
    H100 (``lane_groups.pick`` for a light model); no more threads than
    walkers at small widths."""
    g = FA.flagship_geometry(65536)
    assert (g.blocks, g.walkers, g.threads, g.lanes) == (128, 512, 512, 1)
    assert FA.flagship_geometry(1 << 19).walkers == 1024
    small = FA.flagship_geometry(1000)
    assert small.threads <= small.walkers and small.threads % 32 == 0
