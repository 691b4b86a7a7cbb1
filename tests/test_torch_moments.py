"""The flagship kernels' Philox moment sums and cost (``moments_philox``
and ``centred_cost`` of ``kissabc_tpu_torch/csrc/moments.cuh``, the draw
loop of kernels #1, #2, #7 and #8), compiled for the host with ``g++``
against the emulation in ``tests/host_cuda/`` with fused multiply-adds
rounded once, as on the card (``tests/host_cuda/flagship_main.cpp``).

Near the README target the cost's ``sigma * sd_z - target_sd`` cancels to
~1e-3 of the target, so an error in the sum of squares is magnified
~1000 times (ROADMAP C2: a float32 sum of 1000 squares one after another
put one ``ll`` 4.0e-4 off where the plain version was 4.5e-5 off). Here,
for 4096 walkers x 1000 draws with proposals whose costs lie near the
target, for the walker of that report (seed 2024, stream 7, walker 33906)
and for a walker at its inputs (1.3077836, 0.09632552), the kernel's sum
of squares and its cost are held against float64 over the same float32
draws, and must be no farther off than the plain version's
(``_moments_philox``, ``_summary_cost`` of ``ops/kernels.py``, against
float64 over its own draws) at the 99th percentile and at the maximum.
Skipped without a host C++ compiler.
"""

import subprocess

import numpy as np
import pytest
import torch

from host_cuda.build import build_program
from kissabc_tpu_torch.ops import kernels as K
from torch_threads import one_torch_thread  # noqa: F401

SEED, STREAM = 2024, 7        # the flagship AIS simulator's stream
TARGET = (2.0, 0.04, 50.0)    # target mean, target sd, sd weight
RUN8_WALKER, RUN8_INPUTS = 33906, (1.3077836, 0.09632552)


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    return build_program(tmp_path_factory.mktemp("moments"), "flagship.cu",
                         "flagship_main.cpp", ["KT_EMU_FUSED_FMA"])


def _plain(walkers, ndraws):
    """The plain version's float32 draws [m, ndraws] and sums of the
    walkers (each walker's own Philox counters)."""
    seed = torch.tensor([SEED])
    q = torch.arange(-(-ndraws // 4))
    w = torch.as_tensor(walkers)[:, None]
    x0, x1, x2, x3 = K.philox4x32_10(q[None, :], w, STREAM, 0, seed)
    za, zb = K._box_muller(x0, x1)
    zc, zd = K._box_muller(x2, x3)
    z = torch.stack((za, zb, zc, zd), 2).flatten(1)[:, :ndraws]
    s1 = torch.empty(len(walkers))
    s2 = torch.empty(len(walkers))
    for k, wk in enumerate(walkers):   # _moments_philox numbers walkers
        a, b = K._moments_philox(seed, STREAM, 1, ndraws, "cpu", walker0=wk)
        s1[k], s2[k] = a[0], b[0]
    return z, s1, s2


def _near_target(z64, ndraws, rng):
    """Proposals whose cost lies in ~[1e-4, 5e-3]: sigma within 1e-4 / sd
    of target_sd / sd_z and mu within 3e-3 of the target mean."""
    mz = z64.sum(1) / ndraws
    sd = np.sqrt((z64 * z64).sum(1) / ndraws - mz * mz)
    sg = ((TARGET[1] + rng.uniform(-1e-4, 1e-4, len(sd))) / sd)
    mu = TARGET[0] - sg * mz + rng.uniform(-3e-3, 3e-3, len(sd))
    return mu.astype(np.float32), sg.astype(np.float32)


def _float64_cost(mu, sg, s1, s2, ndraws):
    mz = s1 / ndraws
    vz = np.maximum(s2 / ndraws - mz * mz, 0.0)
    return np.hypot(mu + sg * mz - TARGET[0],
                    (sg * np.sqrt(vz) - TARGET[1]) * TARGET[2])


def _kernel(program, tmp_path, walkers, mu, sg, ndraws):
    """The kernel's (s1, s2c, cost) and float64 (s1, s2, cost) over its
    own draws, per walker."""
    rec = np.zeros(len(walkers), dtype=[("w", "<u4"), ("f", "<f4", 5)])
    rec["w"] = walkers
    rec["f"] = np.stack([mu, sg] + [np.full(len(mu), v, np.float32)
                                    for v in TARGET], 1)
    path, out = tmp_path / "moments.in", tmp_path / "moments.out"
    with open(path, "wb") as f:
        f.write(np.array([SEED, STREAM, ndraws, len(walkers)],
                         np.uint32).tobytes())
        f.write(rec.tobytes())
    subprocess.run([str(program), "moments", str(path), str(out)],
                   check=True, timeout=300)
    res = np.fromfile(out, dtype=[("f", "<f4", 3), ("d", "<f8", 3)])
    return res["f"].astype(np.float64), res["d"]


@pytest.mark.parametrize("ndraws", [1000, 997])
def test_philox_sums_and_cost_no_farther_from_float64_than_plain(
        program, tmp_path, ndraws):
    rng = np.random.default_rng(ndraws)
    walkers = np.concatenate([np.arange(4096), [RUN8_WALKER] * 3])
    z, ps1, ps2 = _plain(walkers, ndraws)
    z64 = z.double().numpy()
    mu, sg = _near_target(z64, ndraws, rng)
    mu[-2], sg[-2] = RUN8_INPUTS          # the report's walker's inputs
    mu[-1], sg[-1] = RUN8_INPUTS[0], sg[-3]
    kf, kd = _kernel(program, tmp_path, walkers, mu, sg, ndraws)
    plain_cost = K._summary_cost(torch.from_numpy(mu), torch.from_numpy(sg),
                                 ps1, ps2, ndraws, *TARGET).double().numpy()
    p64 = (z64.sum(1), (z64 * z64).sum(1))
    p64_cost = _float64_cost(mu.astype(np.float64), sg.astype(np.float64),
                             *p64, ndraws)
    # the kernel's s2 is its centred sum plus ndraws, in float64
    errs = {
        "s2": (np.abs(kf[:, 1] + ndraws - kd[:, 1]),
               np.abs(ps2.double().numpy() - p64[1])),
        "cost": (np.abs(kf[:, 2] - kd[:, 2]) / kd[:, 2],
                 np.abs(plain_cost - p64_cost) / p64_cost),
    }
    assert np.median(p64_cost[:4096]) < 5e-3   # the cancelling regime
    for name, (kern, plain) in errs.items():
        for stat in (lambda e: np.quantile(e, 0.99), np.max):
            assert stat(kern) <= stat(plain), (name, stat(kern), stat(plain))
