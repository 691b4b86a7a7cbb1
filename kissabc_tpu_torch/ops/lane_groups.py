"""Launch geometry of the lane-group kernels, #6 ``kt_fused_ais_sweep`` and
#10 ``kt_fused_abcde_generation``, and of the cost kernel #4
``kt_streaming_moment_cost`` (``csrc/generic.cuh``), and plain models of
what they do with it.

A block covers ``walkers`` walkers with ``threads`` threads. In #6 and
#10, phase 1 runs one thread per walker and compacts the walkers that
need the simulator onto slots in walker order; phase 2 gives each
compacted walker a group of ``lanes`` lanes, the block's groups taking
its compacted walkers in turn, and the group's lanes take the walker's
Philox calls in rounds of ``lanes``. #4 has no phase 1 (every walker
needs the simulator) and one turn: a group of lanes for each of the
block's walkers. The grid is ``ceil(n / walkers)`` blocks.

- ``geometry`` (#6, #10) and ``cost_geometry`` (#4) pick a launch from
  ``n`` (``pick``, ``cost_pick``) and ``check`` (``cost_check``) refuses
  what the kernels cannot take, as their entry points do (they return
  ``cudaErrorInvalidConfiguration``);
- ``lane_share`` is the share of the draw loop's lanes that do useful
  work for a mask of the walkers that need the simulator;
- ``schedule`` replays a group's rounds, stores and loads (the same index
  arithmetic as ``simulate_group``) and returns the order in which each
  accumulating lane adds the draws, so a test can hold it against
  ``simulate()``'s order.

Nothing here needs a card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

# as in csrc/generic.cuh
MAX_THREADS = 512           # kGroupMaxThreads
MAX_WALKERS = 4096          # kGroupMaxWalkers
MAX_SMEM = 232448           # kGroupMaxSmem: a block's dynamic shared memory
# the lanes a generated unit instantiates (group_lanes): the two that
# ``pick`` chooses; a unit whose source defines KT_GROUP_ALL_LANES (the
# geometry grid of tools/time_geometry.py) has ALL_LANES
LANES = (1, 4)
ALL_LANES = (1, 2, 4, 8, 16)
ALL_LANES_DEFINE = "#define KT_GROUP_ALL_LANES 1\n"
H100_SMS = 132


class Geometry(NamedTuple):
    """One launch's blocks and, per block, its walkers, threads and lanes
    per compacted walker."""
    blocks: int
    walkers: int
    threads: int
    lanes: int


def smem_bytes(walkers: int, threads: int, lanes: int, nstats: int,
               slots: bool = True) -> int:
    """Dynamic shared memory of a block (``group_smem``): for ``lanes >
    1`` each warp's staging, two buffers of a row of 33 float2 cells per
    (half, statistic), then (``slots``: #6, #10) the walkers' slots."""
    stage = (threads // 32) * 2 * (2 * nstats) * 33 * 8 if lanes > 1 else 0
    return stage + (4 * walkers if slots else 0)


def unit_lanes(source: str) -> tuple[int, ...]:
    """The lanes that a generated unit's source instantiates."""
    return ALL_LANES if ALL_LANES_DEFINE in source else LANES


def with_all_lanes(unit):
    """``unit`` (``codegen.Generated``) built with every lane count of
    ``ALL_LANES``, for the measurement grids."""
    return dataclasses.replace(unit, source=ALL_LANES_DEFINE + unit.source)


def check(n: int, walkers: int, threads: int, lanes: int, nstats: int,
          built: tuple[int, ...] = LANES, slots: bool = True) -> Geometry:
    """The geometry of one launch over ``n`` walkers, or ``ValueError``
    for what the kernels cannot take: threads a multiple of 32 up to
    ``MAX_THREADS``, 1 to ``MAX_WALKERS`` walkers a block, ``lanes`` one
    of the unit's (``built``, ``unit_lanes``) and the block's shared
    memory (with the walkers' slots, or without for #4: ``slots``)
    within ``MAX_SMEM``."""
    if threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"threads must be a multiple of 32 in [32, "
                         f"{MAX_THREADS}], got {threads}")
    if not 1 <= walkers <= MAX_WALKERS:
        raise ValueError(f"walkers per block must be in [1, {MAX_WALKERS}]"
                         f", got {walkers}")
    if lanes not in built:
        raise ValueError(f"lanes must be one of {built}, got {lanes}")
    smem = smem_bytes(walkers, threads, lanes, nstats, slots)
    if smem > MAX_SMEM:
        raise ValueError(f"{walkers} walkers, {threads} threads and {lanes} "
                         f"lanes with {nstats} statistics need {smem} bytes "
                         f"of shared memory, more than a block's {MAX_SMEM}")
    return Geometry(max(1, -(-n // walkers)), walkers, threads, lanes)


@functools.cache
def sm_count(device: int) -> int:
    """The SM count of CUDA device ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# the user's draw and statistics with at most this many operations a draw
# make a light model. Measured on two models only (PERF.md section 6): the
# flagship model, 3 operations (a multiply-add and a power), and g-and-k,
# 14 (its draw holds exp); the rule is unmeasured between them.
LIGHT_OPS = 4


def is_light(unit) -> bool:
    """Whether a generated unit's draw and statistics are light."""
    return unit.draw_ops + unit.stat_ops <= LIGHT_OPS


def pick(n: int, sms: int, light: bool = False) -> tuple[int, int, int]:
    """(walkers, threads, lanes) of a launch over ``n`` walkers on a card
    of ``sms`` SMs, by measurement on the H100 (PERF.md section 6,
    tools/time_geometry.py):

    - at most 128 walkers an SM: one walker's chain bounds the kernel, so
      blocks of 64 walkers (32 where that leaves an SM without a block),
      256 threads and 4 lanes a walker;
    - more: the card is issue-bound, so about one block an SM (the power
      of two at or above n / sms, at most 1024 walkers) of 512 threads.
      4 lanes a walker, but 1 for a ``light`` model above 256 walkers an
      SM: there the lane groups' staging (~7 of ~55 instructions a draw)
      costs more than the latency they hide, while a draw with
      transcendentals needs the warps that 4 lanes bring (measured at 3
      and at 14 operations a draw, ``LIGHT_OPS``)."""
    per_sm = -(-n // sms)
    if per_sm <= 128:
        return (64 if -(-n // 64) >= sms else 32), 256, 4
    walkers = 256
    while walkers < min(per_sm, 1024):
        walkers *= 2
    return walkers, 512, 1 if light and per_sm > 256 else 4


def geometry(n: int, nstats: int = 2, sms: int = H100_SMS,
             light: bool = False) -> Geometry:
    """The launch of #6 or #10 over ``n`` walkers on a card of ``sms``
    SMs: ``pick``, checked for ``nstats`` statistics."""
    return check(n, *pick(n, sms, light), nstats)


# kernel #4 runs a light model on one lane in blocks of 128 above this
# many walkers an SM (cost_pick)
COST_GROUPS_PER_SM = 128


def cost_pick(n: int, sms: int, light: bool = False,
              nstats: int = 2) -> tuple[int, int, int]:
    """(walkers, threads, lanes) of a #4 launch over ``n`` walkers on a
    card of ``sms`` SMs, by measurement on the H100 (PERF.md section 6,
    ``tools/time_geometry.py --kernels 4``). Every walker simulates, so
    nothing is compacted and a block's threads are its walkers times its
    lanes (one turn):

    - a ``light`` model above ``COST_GROUPS_PER_SM`` walkers an SM: one
      thread per walker in blocks of 128, by the kernel's L = 1 body. The
      flagship model on one lane against the fastest lane groups of
      ``time_geometry``'s grid: 0.0681 against 0.0715 ms at 33792 (256
      an SM), 0.1329 against 0.1401 at 65536, 0.2555 against 0.2842 at
      131072, 0.5022 against 0.5588 at 262144, 1.95 against 2.20 at
      2^20. At 25344 (192 an SM) 4 lanes in one block of 128 an SM ran
      0.0722 against one lane's 0.0681 (blocks of 64, three an SM, ran
      0.0565: PERF.md section 7); at 16384 (124 an SM) 4 lanes won,
      0.0370 against 0.0462;
    - else groups of 4 lanes in about one block an SM: the walkers an SM
      rounded up to a multiple of 8, at most 128 (512 threads; fewer where
      the staging of ``nstats`` statistics would not fit). At 16384 one
      block of 128 an SM ran 0.0370 ms where two of 64 ran 0.0384; a draw
      with transcendentals (g-and-k) gains from 4 lanes at 65536 and
      131072 too (0.2633 against one lane's 0.2901, 0.5238 against
      0.5447), and takes them at every width (unmeasured above 131072)."""
    per_sm = -(-n // sms)
    if light and per_sm > COST_GROUPS_PER_SM:
        return 128, 128, 1
    # 8 walkers a warp of groups of 4, as many warps as their staging fits
    top = min(128, MAX_SMEM // smem_bytes(0, 32, 4, nstats, slots=False) * 8)
    walkers = min(top, -(-per_sm // 8) * 8)
    return walkers, 4 * walkers, 4


def cost_check(n: int, walkers: int, threads: int, lanes: int, nstats: int,
               built: tuple[int, ...] = LANES) -> Geometry:
    """``check`` for #4, whose blocks hold no walkers' slots and give
    each walker one group of lanes (``threads == walkers * lanes``), as
    its entry point refuses."""
    if walkers * lanes != threads:
        raise ValueError(f"a block's threads are its walkers times the "
                         f"lanes, got {walkers} walkers of {lanes} lanes on "
                         f"{threads} threads")
    return check(n, walkers, threads, lanes, nstats, built, slots=False)


def cost_geometry(n: int, nstats: int = 2, sms: int = H100_SMS,
                  light: bool = False) -> Geometry:
    """The launch of #4 over ``n`` walkers on a card of ``sms`` SMs:
    ``cost_pick``, checked for ``nstats`` statistics."""
    return cost_check(n, *cost_pick(n, sms, light, nstats), nstats)


def lane_share(mask, geometry: Geometry) -> float:
    """The share of the draw loop's lanes that do useful work for
    ``mask`` (bool, the walkers that need the simulator): in each block
    the p compacted walkers go to groups g = slot % G (G = threads /
    lanes), so group g runs ceil((p - g) / G) walkers and a warp runs
    while its first group does; the share is sum p * lanes over 32 x the
    warps' runs (1.0 where no walker needs the simulator). ``Geometry(.,
    32, 32, 1)`` gives the share of one thread per walker without
    compaction, where a warp of 32 walkers runs while any of them needs
    the simulator."""
    n = mask.shape[0]
    g = geometry
    padded = torch.zeros(g.blocks * g.walkers, dtype=torch.int64)
    padded[:n] = mask.to(torch.int64).cpu()
    p = padded.view(g.blocks, g.walkers).sum(1)
    groups = g.threads // g.lanes
    first = torch.arange(0, groups, 32 // g.lanes)   # each warp's first group
    runs = torch.clamp(p[:, None] - first[None, :] + groups - 1,
                       min=0) // groups
    lanes = 32 * int(runs.sum())
    return int(p.sum()) * g.lanes / lanes if lanes else 1.0


def schedule(ndraws: int, chunk: int, lanes: int, nstats: int = 2):
    """Replay one warp's groups of ``lanes`` in ``simulate_group``
    (``lanes`` >= 2) or ``simulate`` (``lanes`` = 1): per chunk pair j and
    accumulator q = 2p + half, the draws in the order the owning lane adds
    them, each as (l, valid); an invalid draw is one a round holds past
    the half's draws, stored as +0. Cell (q, c) of a buffer lies at float2
    index q * 33 + c. Raises ``AssertionError`` if a load meets a cell that
    another group or source lane stored, or if the stores (fixed q) or
    the loads (fixed source lane) of a half-warp's 16 lanes hit a bank
    pair twice (a float2 cell is 8 bytes, two of the 32 banks)."""
    accums = 2 * nstats
    nchunks = -(-ndraws // (2 * chunk))
    out = {}
    for j in range(nchunks):
        na = min(chunk, ndraws - 2 * j * chunk)
        nb = max(0, min(chunk, ndraws - 2 * j * chunk - chunk))
        if lanes == 1:
            for q in range(accums):
                out[j, q] = [(l, True) for l in range(nb if q % 2 else na)]
            continue
        order = {q: [] for q in range(accums)}
        for c0 in range(0, (na + 1) // 2, lanes):
            cells = {}   # float2 index -> (source lane, draws, group)
            for q in range(accums):
                banks = {}
                for gw in range(32 // lanes):
                    for r in range(lanes):
                        lane = gw * lanes + r
                        l = 2 * (c0 + r)
                        half = nb if q % 2 else na
                        at = q * 33 + lane
                        assert at not in cells
                        cells[at] = (r, [(l, l < half), (l + 1, l + 1 < half)],
                                     gw)
                        banks.setdefault(lane // 16, []).append(at % 16)
                for pairs in banks.values():     # stores of a half-warp
                    assert len(set(pairs)) == len(pairs)
            for i in range(-(-accums // lanes)):
                for src in range(lanes):
                    banks = {}
                    for gw in range(32 // lanes):
                        for r in range(lanes):
                            q = r + i * lanes
                            if q >= accums:
                                continue
                            at = q * 33 + gw * lanes + src
                            banks.setdefault((gw * lanes + r) // 16,
                                             []).append(at % 16)
                            stored_by, draws, owner = cells[at]
                            assert owner == gw and stored_by == src
                            if gw == 0:
                                order[q].extend(draws)
                    for pairs in banks.values():  # loads of a half-warp
                        assert len(set(pairs)) == len(pairs)
        for q in range(accums):
            out[j, q] = order[q]
    return out
