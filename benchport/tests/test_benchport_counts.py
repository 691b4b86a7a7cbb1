"""The roofline's frozen counts: pinned to hand counts, and read from
nothing of the measured package."""

import ast
from pathlib import Path

import pytest

import jobs
from metrics import _counts

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name, per_draw, reduce_ops, prior_ops, nstats, "
                         "nleaves", [
    # noise 27, g-and-k draw 13, 7 indicators, 7 sums; 7 indicators, 4
    # leaves
    ("gk-ecdf", 54, 28, 16, 7, 4),
    # noise 27, mu + sigma z 2, x*x 1, 2 sums; E[x], E[x^2]; mu, sigma
    ("normal-readme", 32, 13, 10, 2, 2),
])
def test_frozen_counts(name, per_draw, reduce_ops, prior_ops, nstats,
                       nleaves):
    cfg, mod = jobs.load_config(name)
    assert (mod.OPS_PER_DRAW, mod.REDUCE_OPS, mod.PRIOR_OPS, mod.NSTATS,
            mod.NLEAVES) == (per_draw, reduce_ops, prior_ops, nstats,
                             nleaves)
    # the frozen sizes are the model's own
    model = mod.model(cfg, mod.make_data(cfg))
    assert (model.nmoments, len(model.ref_prior)) == (nstats, nleaves)


def test_launch_counts_by_hand():
    cfg, mod = jobs.load_config("gk-ecdf")
    n, nsim = 1 << 20, 900_000
    ops, nbytes = _counts.smc_sweep(mod, cfg, n, nsim)
    assert ops == n * (106 + 4 * 4 + 16) + nsim * (2000 * 54 + 28)
    assert nbytes == n * (8 * 6 + 2)
    assert _counts.streaming_cost(mod, cfg, n) == (n * 2000 * 54,
                                                    4 * n * (4 + 7))
    cfg, mod = jobs.load_config("normal-readme")
    ops, nbytes = _counts.ais_half(mod, cfg, 65536, 40000)
    # 9 words from 3 Philox calls (240), their mantissa tricks (27), 3
    # Box-Muller pairs (24), the move constants (12), the accept (10), the
    # commit of lp and ll (2); 25 a leaf; the prior 10
    assert ops == 65536 * (315 + 25 * 2 + 10) + 40000 * (1000 * 32 + 13)
    assert nbytes == 65536 * (8 * 4 + 8)
    assert _counts.least_seconds(67e12, 0) == 1.0
    assert _counts.least_seconds(0, 3.35e12) == 1.0


# the measured package's own operation constants and work functions
PORT_COUNTS = {"NOISE_OPS", "SWEEP_OPS", "SWEEP_OPS_PER_LEAF",
               "AIS_OPS_PER_WALKER", "GEN_AIS_OPS_PER_WORD",
               "GEN_AIS_OPS_PER_PAIR", "draw_ops", "stat_ops", "prior_ops",
               "push_ops", "reduce_ops", "work"}


def test_nothing_reads_the_ports_counts():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in PORT_COUNTS:
                owner = ast.unparse(node.value)
                assert owner in ("job", "self"), (path, owner, node.attr)
            if isinstance(node, ast.ImportFrom) and node.module:
                assert not node.module.startswith("kissabc_tpu"), path
