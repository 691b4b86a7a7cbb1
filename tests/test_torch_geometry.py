"""The launch geometry of the lane-group kernels #6 and #10
(``kissabc_tpu_torch/ops/lane_groups.py``, ``geometry``) and of the cost
kernel #4 (``cost_geometry``): the grid covers every walker, the
production width of ABCDE puts a block on every SM,
``check`` refuses what the kernels cannot take, a unit has the lanes 1
and 4 unless it asks for all; the lane share that compaction gives on
the masks of the plain versions; and a plain replay of the lane-group
schedule of ``simulate_group`` (``csrc/generic.cuh``): every draw is made
once and summed in ``simulate()``'s order, the padded zeros change no
bit, and the staging stores and loads are free of bank conflicts. The
kernels themselves are held against their plain versions, at every
measured geometry, on the card by chip_smoke.py.
"""

import re

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.core import abcde as AB
from kissabc_tpu_torch.ops import fused_abcde as FD
from kissabc_tpu_torch.ops import lane_groups as LG
from kissabc_tpu_torch.utils.rng import as_generator
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n", [1, 31, 300, 1000, 4096, 16384, 16384 + 37,
                               131072, 1 << 20])
@pytest.mark.parametrize("light", [False, True])
def test_grid_covers_every_walker(light, n):
    g = LG.geometry(n, light=light)
    assert g.blocks * g.walkers >= n > (g.blocks - 1) * g.walkers
    assert g.threads % 32 == 0 and 32 // g.lanes * g.lanes == 32
    assert LG.smem_bytes(g.walkers, g.threads, g.lanes, 2) <= LG.MAX_SMEM


def test_production_widths_put_a_block_on_every_sm():
    """At ABCDE's 16384 walkers one thread per walker in blocks of 128
    left 4 of 132 SMs idle; the geometry spreads the walkers so that
    every SM gets a block, with at most ~124 walkers an SM, and gives each
    simulated walker 4 lanes, light model or not."""
    for light in (False, True):
        g = LG.geometry(16384, light=light)
        assert g.blocks >= LG.H100_SMS and g.lanes == 4
        assert -(-16384 // LG.H100_SMS) <= 2 * g.walkers <= 256
    assert LG.geometry(1000).blocks == 32


@pytest.mark.parametrize("light,lanes", [(False, 4), (True, 1)])
def test_issue_bound_widths_take_a_block_an_sm(light, lanes):
    """Above 128 walkers an SM: about one block of 512 threads an SM (128
    blocks of 1024 walkers at 131072, of 512 for a half of 65536), with 4
    lanes a walker, or 1 for a light model above 256 walkers an SM."""
    assert LG.geometry(131072, light=light) == (128, 1024, 512, lanes)
    assert LG.geometry(65536, light=light) == (128, 512, 512, lanes)
    assert LG.geometry(30000, light=light).lanes == 4   # 228 an SM


def test_light_models():
    """The flagship model's draw and statistics are light, g-and-k's are
    not (its draw holds exp and more): the two operation counts, 3 and
    14, that the rule was measured on."""
    for make, light, ops in ((models.flagship, True, 3),
                             (models.g_and_k, False, 14)):
        prior, draw, reduce_cost = make()
        u = kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=1.0).unit
        assert LG.is_light(u) == light and u.draw_ops + u.stat_ops == ops


@pytest.mark.parametrize("walkers,threads,lanes,nstats,what", [
    (64, 0, 8, 2, "multiple of 32"),
    (64, 48, 8, 2, "multiple of 32"),
    (64, 1056, 8, 2, "multiple of 32"),
    (64, 1024, 8, 2, "multiple of 32"),
    (64, -32, 8, 2, "multiple of 32"),
    (0, 256, 8, 2, "walkers per block"),
    (4097, 256, 8, 2, "walkers per block"),
    (64, 256, 3, 2, "lanes must be one of"),
    (64, 256, 32, 2, "lanes must be one of"),
    (64, 256, 0, 2, "lanes must be one of"),
    (64, 512, 4, 16, "shared memory"),
])
def test_geometries_the_kernels_cannot_take_raise(walkers, threads, lanes,
                                                  nstats, what):
    for n in (16384, 65536):
        for built in (LG.LANES, LG.ALL_LANES):
            with pytest.raises(ValueError, match=what):
                LG.check(n, walkers, threads, lanes, nstats, built)


@pytest.mark.parametrize("lanes", [2, 8, 16])
def test_a_unit_has_lanes_1_and_4_unless_it_asks_for_all(lanes):
    """The lanes that ``pick`` never chooses are refused for a unit
    built as the wrappers build it, and taken for one built with
    ``with_all_lanes`` (the measurement grids)."""
    prior, draw, reduce_cost = models.flagship()
    g = kt.make_fused_abcde_generation(prior, draw, reduce_cost, gamma=1.19)
    assert LG.unit_lanes(g.unit.source) == LG.LANES == (1, 4)
    with pytest.raises(ValueError, match="lanes must be one of"):
        LG.check(16384, 64, 256, lanes, 2, LG.unit_lanes(g.unit.source))
    every = LG.with_all_lanes(g.unit)
    assert LG.unit_lanes(every.source) == LG.ALL_LANES
    assert every.source.endswith(g.unit.source)
    assert LG.check(16384, 64, 256, lanes, 2,
                    LG.unit_lanes(every.source)).lanes == lanes
    for n in (1000, 16384, 131072, 1 << 20):
        for light in (False, True):
            assert LG.geometry(n, light=light).lanes in LG.LANES


@pytest.mark.parametrize("n,light,want", [
    (1000, True, (125, 8, 32, 4)), (1000, False, (125, 8, 32, 4)),
    (16384, True, (128, 128, 512, 4)), (16384, False, (128, 128, 512, 4)),
    (16896, True, (132, 128, 512, 4)), (16897, True, (133, 128, 128, 1)),
    (131072, True, (1024, 128, 128, 1)), (131072, False, (1024, 128, 512, 4)),
    (1 << 20, True, (8192, 128, 128, 1)),
    (1 << 20, False, (8192, 128, 512, 4))])
def test_cost_default_geometry(n, light, want):
    """Kernel #4 (``cost_geometry``, by measurement on the H100): groups
    of 4 lanes, one turn each, in about one block an SM (1000:
    smc-fused-generic's init; 16384: ABCDE's split generations; g-and-k
    at 131072), but a light model (the flagship draw) above 128 walkers
    an SM (16896 = 128 x 132) on one lane, one thread a walker in blocks
    of 128 (2^20: smc-1m-generic)."""
    g = LG.cost_geometry(n, light=light)
    assert g == want
    assert g.blocks * g.walkers >= n > (g.blocks - 1) * g.walkers
    assert g.threads == g.walkers * g.lanes


@pytest.mark.parametrize("n", [1, 31, 300, 1000, 4096, 16384, 16384 + 37,
                               33792, 33793, 131072])
def test_cost_grid_covers_every_walker_on_every_sm(n):
    """About one block an SM: the walkers an SM rounded up to a multiple
    of 8 in one block where that holds at most 128 (so no SM takes two
    blocks), blocks of 128 above; the staging of 16 statistics fits."""
    g = LG.cost_geometry(n)
    assert g.blocks * g.walkers >= n > (g.blocks - 1) * g.walkers
    assert g.lanes == 4 and g.threads == 4 * g.walkers
    per_sm = -(-n // LG.H100_SMS)
    if per_sm <= 128:
        assert g.blocks <= LG.H100_SMS
        assert g.walkers - 8 < per_sm <= g.walkers
    else:
        assert g.walkers == 128
    wide = LG.cost_geometry(n, nstats=16)   # 16 statistics: less staging
    assert wide.walkers <= g.walkers and wide.walkers <= 104
    assert wide.blocks * wide.walkers >= n


def test_cost_check_counts_no_slots():
    """#4 has no compaction, so its shared memory is the staging alone:
    4096 walkers a block fit beside 512 threads' staging of 2 statistics
    (with slots they need 16384 bytes more), 16 statistics on 512
    threads of 4 lanes do not."""
    assert LG.smem_bytes(4096, 512, 4, 2, slots=False) == \
        LG.smem_bytes(4096, 512, 4, 2) - 4 * 4096
    assert LG.check(65536, 4096, 512, 4, 2, slots=False).blocks == 16
    with pytest.raises(ValueError, match="shared memory"):
        LG.check(65536, 128, 512, 4, 16, slots=False)
    assert LG.check(65536, 128, 512, 1, 16, slots=False).lanes == 1


def test_cost_check_takes_a_group_of_lanes_a_walker():
    assert LG.cost_check(65536, 128, 128, 1, 2).blocks == 512
    assert LG.cost_check(65536, 8, 32, 4, 2).blocks == 8192
    for walkers, threads, lanes in ((128, 256, 1), (256, 128, 1),
                                    (1, 32, 1), (16, 128, 4), (8, 64, 4)):
        with pytest.raises(ValueError, match="walkers times the lanes"):
            LG.cost_check(65536, walkers, threads, lanes, 2)
    with pytest.raises(ValueError, match="lanes must be one of"):
        LG.cost_check(65536, 8, 64, 8, 2)


def test_limits_match_the_kernel():
    text = open(kt.__path__[0] + "/csrc/generic.cuh").read()
    for name, value in (("kGroupMaxThreads", LG.MAX_THREADS),
                        ("kGroupMaxWalkers", LG.MAX_WALKERS),
                        ("kGroupMaxSmem", LG.MAX_SMEM)):
        assert f"constexpr int {name} = {value};" in text
    every, default = re.search(
        r"#if defined\(KT_GROUP_ALL_LANES\) && KT_GROUP_ALL_LANES\n"
        r"inline bool group_lanes\(int lanes\) \{(.*?)\}\n#else\n"
        r"inline bool group_lanes\(int lanes\) \{(.*?)\}\n#endif", text,
        re.S).groups()
    for body, want in ((every, LG.ALL_LANES), (default, LG.LANES)):
        assert tuple(int(x) for x in re.findall(r"lanes == (\d+)",
                                                body)) == want
    assert LG.ALL_LANES_DEFINE == "#define KT_GROUP_ALL_LANES 1\n"


def test_lane_share_counts_whole_warps_per_block():
    g = LG.check(512, 256, 256, 8, 2, LG.ALL_LANES)   # 2 blocks of 32
    mask = torch.zeros(512, dtype=torch.bool)
    assert LG.lane_share(mask, g) == 1.0
    mask[:4] = True                        # block 0: 4 walkers, one warp
    assert LG.lane_share(mask, g) == 4 * 8 / 32
    mask[256:256 + 33] = True              # block 1: 33 walkers
    # block 1: group 0 runs 2 walkers, so warp 0 runs twice, warps 1-7 once
    assert LG.lane_share(mask, g) == (4 + 33) * 8 / (32 * (1 + 2 + 7))
    one = LG.check(64, 32, 32, 1, 2)       # one thread per walker
    m = torch.zeros(64, dtype=torch.bool)
    m[[0, 40, 41]] = True
    assert LG.lane_share(m, one) == 3 / 64


def _abcde_gate(n, seed=1):
    """The gate mask of an ABCDE generation on the flagship model at its
    production inputs: prior samples, costs of the streaming simulator,
    the rank trick's bases and partners (as chip_smoke.py does)."""
    prior, draw, reduce_cost = models.flagship()
    g = kt.make_fused_abcde_generation(prior, draw, reduce_cost, gamma=1.19,
                                       ndraws=100)
    gen = as_generator(seed, "cpu")
    th = list(prior.sample_tree(gen, n))
    lps = prior.logpdf_tree(tuple(th)).float()
    ds = kt.make_streaming_moment_cost(draw, reduce_cost, ndraws=100)(
        tuple(th), gen)
    eps_i = torch.clamp(ds.min(), min=1e-6).expand(n)
    order, count = AB.rank_count(ds)
    v = FD.uint32_words(gen, 3 * n).reshape(3, n)
    parents = AB.bases_from_words(v, ds, eps_i, order, count)
    bases = [[x[i] for x in th] for i in parents]
    return g.gate_plain(bases, lps, torch.ones(n), 7)[3]


def _ais_inside(h, seed=2):
    prior, draw, reduce_cost = models.flagship()
    sw = kt.make_fused_ais_sweep(prior, draw, reduce_cost, scale=0.005,
                                 ndraws=100)
    th = list(prior.sample_tree(as_generator(seed, "cpu"), 2 * h))
    shifts = torch.tensor([5, 77, 1000, 3, 40000, 65001]) % h
    return sw.proposal_plain([x[:h] for x in th], [x[h:] for x in th],
                             shifts, 11)[3]


def test_lane_share_of_the_generations_gate_mask():
    """About a third of the walkers pass ABCDE's prior gate: one thread
    per walker keeps that share of a warp's lanes busy, the compacted lane
    groups of the default geometry ~90% or more."""
    n = 16384
    gate = _abcde_gate(n)
    rate = float(gate.float().mean())
    assert 0.2 < rate < 0.5
    masked = LG.lane_share(gate, LG.check(n, 32, 32, 1, 2))
    assert abs(masked - rate) < 0.05
    compacted = LG.lane_share(gate, LG.geometry(n))
    assert compacted > 0.85 and compacted > 2 * masked


def test_lane_share_of_the_half_updates_inside_mask():
    """~59% of the flagship walkers propose inside the prior from the
    prior's own samples; compaction keeps >= 85% of the lanes busy."""
    h = 65536
    inside = _ais_inside(h)
    rate = float(inside.float().mean())
    assert 0.5 < rate < 0.7
    masked = LG.lane_share(inside, LG.check(h, 32, 32, 1, 2))
    assert abs(masked - rate) < 0.05
    compacted = LG.lane_share(inside, LG.geometry(h))
    assert compacted > 0.85 and compacted > masked + 0.2


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("ndraws,chunk", [(1000, 512), (257, 512), (1, 512),
                                          (1000, 64), (257, 64), (1, 64)])
def test_schedule_sums_every_draw_once_in_simulate_order(lanes, ndraws,
                                                         chunk):
    """Each accumulator (half, statistic) of each chunk pair adds the
    half's draws 0, 1, ..., in order, each once, then only padded zeros;
    and sums so padded equal the plain sums bit for bit in float32."""
    order = LG.schedule(ndraws, chunk, lanes)
    want = LG.schedule(ndraws, chunk, 1)
    assert order.keys() == want.keys()
    rng = np.random.default_rng(lanes * 1000 + ndraws + chunk)
    for key, seq in order.items():
        valid = [l for l, ok in seq if ok]
        assert valid == [l for l, _ in want[key]]
        assert all(ok for _, ok in seq[:len(valid)])   # padding trails
        vals = rng.standard_normal(max(len(seq), 1)).astype(np.float32) ** 3
        plain = np.float32(0.0)
        for l in valid:
            plain = np.float32(plain + vals[l])
        padded = np.float32(0.0)
        for l, ok in seq:
            padded = np.float32(padded + (vals[l] if ok else np.float32(0)))
        assert padded.tobytes() == plain.tobytes()


@pytest.mark.parametrize("lanes,nstats", [(2, 3), (4, 3), (8, 1), (16, 2),
                                          (4, 16)])
def test_schedule_for_other_statistic_counts(lanes, nstats):
    """More accumulators than lanes (a lane owns several) and fewer (some
    lanes own none) keep the order and the conflict-free layout."""
    order = LG.schedule(300, 64, lanes, nstats)
    want = LG.schedule(300, 64, 1, nstats)
    for key, seq in order.items():
        assert [l for l, ok in seq if ok] == [l for l, _ in want[key]]


def test_padded_zero_changes_no_running_sum():
    """The padding rule: a float32 running sum that starts at +0 is never
    -0, and x + (+0) is x for every other x, infinities and NaN too."""
    xs = np.array([0.0, -0.0, 1e-45, -1e-45, 1.0, -3.5, np.inf, -np.inf,
                   np.nan, 3.4e38], np.float32)
    for x in xs:
        s = np.float32(0.0) + x            # a sum after one add
        assert not (s == 0 and np.signbit(s))
        t = np.float32(s + np.float32(0.0))
        assert t.tobytes() == s.tobytes()
