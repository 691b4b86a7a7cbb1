"""The plain reference against the port's plain versions on the CPU: the
same random words, the same draws, and readings at rounding level."""

import numpy as np
import pytest
import torch

from reference import ais_judge, philox, smc_judge, streams


def test_philox_matches_the_ports_words():
    from kissabc_tpu_torch.ops.kernels import philox4x32_10
    g = torch.Generator().manual_seed(3)
    c = torch.randint(0, 1 << 32, (4, 257), generator=g, dtype=torch.int64)
    key = torch.randint(0, 1 << 32, (257,), generator=g, dtype=torch.int64)
    ours = philox.philox(c[0], c[1], c[2], c[3], key)
    theirs = philox4x32_10(c[0], c[1], c[2], c[3], key)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ndraws", [7, 600, 1500])
def test_simulator_draws_match_the_ports_moments(ndraws):
    """The normals the reference works out for each walker give the first
    moment the port's plain streamed cost gives, at float32 rounding."""
    from kissabc_tpu_torch.ops.streaming import streaming_moment_cost_plain
    n, seed = 300, torch.tensor([987654321])
    theta = torch.zeros(n)
    m = streaming_moment_cost_plain(
        lambda th, e: th + e, None, 2, theta, seed, n=n, ndraws=ndraws,
        chunk=512, noise="normal", bits="hw", sb_rows=1024,
        stream=streams.STREAM_COST)
    z = streams.sim_noise(seed[0], torch.arange(n), ndraws, 512,
                          streams.STREAM_COST)
    assert torch.allclose(z.mean(1), m[0].double(), atol=1e-5)
    assert torch.allclose((z * z).mean(1), m[1].double(), rtol=1e-5)


def test_generator_words_replay_torch_draws():
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    a = torch.randint(0, 1 << 32, (7,), generator=g, dtype=torch.int64)
    b = torch.randint(0, 1 << 32, (7,), generator=g, dtype=torch.int64)
    wa, st = streams.generator_words(state, 7, "cpu")
    wb, _ = streams.generator_words(st, 7, "cpu")
    assert torch.equal(a, wa) and torch.equal(b, wb)


def test_rotations_match_the_ports_rule():
    from kissabc_tpu_torch.ops.fused_ais import rot_shifts6
    g = torch.Generator().manual_seed(5)
    for h in (7, 64, 65536):
        w = torch.randint(0, 1 << 32, (6,), generator=g, dtype=torch.int64)
        assert ais_judge.rotations(w.tolist(), h) == rot_shifts6(w, h).tolist()


def test_roll_shifts_match_the_ports_rule():
    from kissabc_tpu_torch.ops.moves import roll_shifts
    for w0, w1 in ((0, 0), (5, 5), (2**32 - 1, 12345), (77, 76)):
        assert smc_judge.roll_shifts(w0, w1, 1000) == tuple(
            int(v) for v in roll_shifts([w0, w1], 1000))


def test_type7_quantile():
    x = torch.tensor([3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0])
    for q in (0.0, 0.3, 0.95, 1.0):
        assert float(smc_judge.type7(x, q)) == pytest.approx(
            float(np.quantile(x.numpy().astype(np.float64), q)))
