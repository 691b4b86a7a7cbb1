"""The fused flagship smc sweep #2 (``kt_fused_sweep`` of
``kissabc_tpu_torch/csrc/flagship.cu``), compiled for the host with
``g++`` against the emulation in ``tests/host_cuda/cuda_runtime.h`` (one
thread per CUDA thread, the warp collectives as rendezvous that fail on a
lane outside the mask or a deadlock), through
``tests/host_cuda/flagship_main.cpp``.

- The rotation shifts the kernel derives from the step's two raw words
  equal ``roll_shifts``' for n in {3, 4, 5, 1000, 131072}.
- Every launch geometry (256, 512 and 1024 walkers a block among others,
  32 to 512 threads, a population of 1100 walkers that no block size
  divides) gives the outputs of one thread per walker bit for bit, on
  Philox and stub bits, with ragged draw counts, eps read from memory or
  taken as an argument.
- One thread per walker, with the partners from the words, agrees with
  ``fused_sweep_plain`` on the rolls ``roll_shifts`` makes of the same
  words within the JAX golden tolerance (rtol 2e-4, atol 2e-5) on
  committed values, the commit masks equal but where a cost lies within
  1e-5 of eps; walkers that do not commit keep their inputs bit for bit.
- On the CPU, ``fused_sweep_words`` is the plain version on those rolls,
  and ``make_fused_flagship_sweep``'s step draws its three words from the
  generator as before.

The emulation checks the kernel's control flow, index arithmetic and bit
coordinates; its arithmetic on the card is held against the plain version
by chip_smoke.py. Skipped without a host C++ compiler.
"""

import subprocess

import numpy as np
import pytest
import torch

from host_cuda.build import build_program
from kissabc_tpu_torch.ops import kernels as K
from kissabc_tpu_torch.ops.moves import roll_shifts
from kissabc_tpu_torch.utils.rng import as_generator, uint32_words
from torch_threads import one_torch_thread  # noqa: F401

N = 1100             # walkers: no block size divides it
RTOL, ATOL, BAND = 2e-4, 2e-5, 1e-5
# (walkers, threads)
GEOMETRIES = [(512, 512), (512, 256), (256, 256), (256, 32), (1024, 512),
              (1024, 1024), (1024, 64), (512, 128), (256, 512), (37, 64),
              (100, 96)]
CONSTS = K.fused_sweep_constants(max_stretch=2.0, mu_lo=1.0, mu_hi=3.0,
                                 sg_sigma=0.05, sg_lo=0.0, sg_hi=100.0)


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    return build_program(tmp_path_factory.mktemp("fused_sweep"),
                         "flagship.cu", "flagship_main.cpp",
                         ["KT_EMU_FUSED_FMA"])


def _words(rng, count):
    return torch.as_tensor(rng.integers(0, 1 << 32, count, dtype=np.int64))


def _start(seed, n=N):
    """mu ~ U(1, 3), sigma ~ U(0.01, 0.1), costs in [0.2, 1], the prior's
    logpdf, and the step's three words."""
    rng = np.random.default_rng(seed)
    mu = torch.as_tensor(rng.uniform(1, 3, n).astype(np.float32))
    sg = torch.as_tensor(rng.uniform(0.01, 0.1, n).astype(np.float32))
    xs = torch.as_tensor(rng.uniform(0.2, 1.0, n).astype(np.float32))
    lps = (CONSTS["lp_const"] - sg * sg * CONSTS["half_inv_var"]).float()
    return [mu, sg, xs, lps], _words(rng, 3)


def _kw(bits, ndraws, chunk, block):
    return dict(ndraws=ndraws, target_mu=2.0, target_sd=0.04,
                sd_weight=50.0, block=block, chunk=chunk, bits=bits)


def _run(program, tmp_path, ins, eps, words, kw, geometries):
    """(one thread per walker's outputs, [(error code, outputs)] per
    geometry): (omu, osg, oxs, olps, commit)."""
    n = ins[0].shape[0]
    f, i = K.sweep_consts(CONSTS, **kw)
    path = tmp_path / "sweep.in"
    with open(path, "wb") as fh:
        fh.write(np.int32(n).tobytes())
        for x in ins:
            fh.write(x.numpy().tobytes())
        fh.write(np.float32(eps).tobytes())
        fh.write(words.numpy().astype(np.int64).tobytes())
        fh.write(f.tobytes())
        fh.write(i.tobytes())
    out = tmp_path / "sweep"
    args = [str(x) for g in geometries for x in g]
    lines = subprocess.run([str(program), "sweep", str(path), str(out),
                            *args], capture_output=True, text=True,
                           timeout=600, check=True).stdout.splitlines()

    def read(suffix):
        raw = np.fromfile(f"{out}.{suffix}", np.uint8)
        fl = torch.as_tensor(raw[:16 * n].view(np.float32)).reshape(4, n)
        return list(fl) + [torch.as_tensor(raw[16 * n:].copy())]

    return read("ref"), [(int(line.split()[2]), read(k))
                         for k, line in enumerate(lines)]


@pytest.mark.parametrize("n", [3, 4, 5, 1000, 131072])
def test_in_kernel_rolls_equal_roll_shifts(program, n):
    rng = np.random.default_rng(n)
    sets = [_words(rng, 2) for _ in range(60)]
    sets += [torch.zeros(2, dtype=torch.int64),
             torch.full((2,), (1 << 32) - 1, dtype=torch.int64),
             torch.tensor([n - 2, n - 3]), torch.tensor([n - 1, 0])]
    args = [str(x) for w in sets for x in [n, *w.tolist()]]
    out = subprocess.run([str(program), "rolls", *args], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    got = [tuple(int(x) for x in line.split()) for line in out.splitlines()]
    assert got == [roll_shifts(w.tolist(), n) for w in sets]


@pytest.mark.parametrize("bits,ndraws,chunk,block", [
    ("hw", 130, 32, 256), ("stub", 130, 32, 256), ("hw", 77, 512, 2048),
    ("stub", 3, 512, 2048)])
def test_every_geometry_gives_the_bits_of_one_thread_per_walker(
        program, tmp_path, bits, ndraws, chunk, block):
    ins, words = _start(1)
    ref, runs = _run(program, tmp_path, ins, 0.5, words,
                     _kw(bits, ndraws, chunk, block), GEOMETRIES)
    for (err, got), geo in zip(runs, GEOMETRIES):
        assert err == 0, geo
        for g, r in zip(got, ref):
            assert torch.equal(g.view(torch.uint8), r.view(torch.uint8)), geo
    commit = ref[4].bool()
    assert 0 < int(commit.sum()) < N    # some walkers commit, some do not


@pytest.mark.parametrize("bits", ["hw", "stub"])
def test_one_thread_per_walker_matches_the_plain_version(program, tmp_path,
                                                         bits):
    ins, words = _start(2)
    kw = _kw(bits, 200, 64, 256)
    eps = 0.5
    ref, _ = _run(program, tmp_path, ins, eps, words, kw, [])
    dmu, dsg = K.sweep_partners(ins[0], ins[1], words)
    want = K.fused_sweep_plain(ins[0], ins[1], dmu, dsg, ins[2], ins[3], eps,
                               words[2:], consts=CONSTS, **kw)
    gcm, wcm = ref[4].bool(), want[4]
    border = ((ref[2] - eps).abs() < BAND) | ((want[2] - eps).abs() < BAND)
    assert not bool(((gcm != wcm) & ~border).any())
    both = gcm & wcm
    assert int(both.sum()) > 0
    for g, w, x in zip(ref[:4], want[:4], ins):
        torch.testing.assert_close(g[both], w[both], rtol=RTOL, atol=ATOL)
        assert torch.equal(g[~gcm], x[~gcm])


def test_entry_point_refuses_what_the_kernel_cannot_take(program, tmp_path):
    """cudaErrorInvalidConfiguration (9) and nothing written; the Python
    geometry check refuses the same."""
    ins, words = _start(3)
    bad = [(256, 48), (0, 64), (1025, 64), (256, 2048), (256, 0)]
    _, runs = _run(program, tmp_path, ins, 0.5, words,
                   _kw("hw", 10, 512, 2048), bad)
    assert [err for err, _ in runs] == [9] * len(bad)
    assert all(bool((o[0] == -7.0).all() & (o[4] == 7).all())
               for _, o in runs)
    for walkers, threads in bad:
        with pytest.raises(ValueError):
            K.check_sweep_geometry(N, walkers, threads)
    small, words = _start(4, n=2)
    _, runs = _run(program, tmp_path, small, 0.5, words,
                   _kw("hw", 10, 512, 2048), [(512, 512)])
    assert runs[0][0] == 9           # n < 3


def test_words_form_on_cpu_is_the_plain_version_on_the_rolls():
    ins, words = _start(5, n=300)
    kw = _kw("hw", 100, 512, 2048)
    got = K.fused_sweep_words(*ins, 0.5, words, **kw)
    r1, r2 = roll_shifts(words[:2].tolist(), 300)
    dmu = torch.roll(ins[0], r2) - torch.roll(ins[0], r1)
    dsg = torch.roll(ins[1], r2) - torch.roll(ins[1], r1)
    want = K.fused_sweep(ins[0], ins[1], dmu, dsg, ins[2], ins[3], 0.5,
                         words[2:], **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the step draws three words a step from the generator, as before
    step = K.make_fused_flagship_sweep(300, ndraws=100)
    gen, gen2 = as_generator(9, "cpu"), as_generator(9, "cpu")
    (omu, osg), oxs, olps, acc = step(gen, ins[:2], ins[2], ins[3], 0.5)
    w2 = uint32_words(gen2, 3)
    want = K.fused_sweep_words(*ins, 0.5, w2, **kw)
    for g, w in zip((omu, osg, oxs, olps), want[:4]):
        assert torch.equal(g, w)
    assert int(acc) == int(want[4].sum())
    assert torch.equal(uint32_words(gen, 1), uint32_words(gen2, 1))
    with pytest.raises(ValueError, match="int64 of shape"):
        K.fused_sweep_words(*ins, 0.5, words[:2], **kw)


def test_the_default_geometry():
    """About one block an SM of 1024 walkers on 1024 threads at n =
    131072 on the H100 (the walkers of ``lane_groups.pick`` for a light
    model, one thread each); at small widths as many threads as
    walkers."""
    g = K.sweep_geometry(131072)
    assert (g.blocks, g.walkers, g.threads, g.lanes) == (128, 1024, 1024, 1)
    small = K.sweep_geometry(1000)
    assert small.threads == small.walkers and small.threads % 32 == 0
