"""``ais_sweeps``: a kernelized AIS chain of the port's fused sweep
(kernel #6) in blocks of sweeps run back to back, from an init made in
set-up (kernel #4). The configuration's ``ais`` group gives the
walkers, the scale and the stretch; the traffic file ``block_sweeps``,
``warm_blocks``, ``min_blocks``, ``judged_walkers`` and
``judged_sweeps``."""

from __future__ import annotations

import time

import torch

from jobs import Job, clone, derive, leaves
from reference.ais_judge import AISJudge


class Kind(Job):
    def __init__(self, *a):
        super().__init__(*a)
        a = self.cfg["ais"]
        self.n, self.scale = int(a["nwalkers"]), float(a["scale"])
        self.block = int(self.traffic["block_sweeps"])
        m = self.model
        self.cost = self.kt.make_streaming_moment_cost(m.draw, m.reduce,
                                                       **self.kw)
        self.sweep = self.kt.make_fused_ais_sweep(
            self.prior, m.draw, m.reduce, scale=self.scale,
            a_stretch=a["a_stretch"], **self.kw)
        self.snaps = {}

    def setup(self):
        kt_cost = self.cost
        rec = {}

        def cost(thetas, gen):
            rec["state"] = gen.get_state()
            rec["pushed"] = clone(leaves(thetas))
            out = kt_cost(thetas, gen)
            rec["costs"] = out.clone()
            return out

        dens = self.kt.ApproxKernelizedPosterior(self.prior, cost, self.scale,
                                                 cost_vectorized=True)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive(self.seed, "init"))
        th = dens.init_batch(gen, self.n)
        ld = dens.loglike_batch(dens.push(th), gen)
        rec["lds"] = tuple(x.clone() for x in ld)
        self.init = rec
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(derive(self.seed, "chain"))
        self.th, self.ld = th, ld
        for _ in range(int(self.traffic["warm_blocks"])):
            self.run_block()
        self.sync()

    def snapshot(self):
        return (self.gen.get_state(), clone(leaves(self.th)),
                tuple(x.clone() for x in self.ld))

    def keep(self, i):
        """The state at the start of block ``i``; of the earlier ones only
        the last and those of the profiled block's start and end stay on
        the card, for the judges to replay and to tie to."""
        self.snaps[i] = self.snapshot()
        p = self.profiled
        if p is None or i - 2 not in (p, p + 1):
            self.snaps.pop(i - 2, None)

    def run_block(self):
        th, ld, gen, sweep = self.th, self.ld, self.gen, self.sweep
        for _ in range(self.block):
            th, ld = sweep(gen, th, ld)
        self.th, self.ld = th, ld

    def window(self, seconds, trace, rng):
        """Blocks of sweeps back to back until ``seconds`` have passed (at
        least ``min_blocks``), the card synchronised at each block's end;
        the state at each block's start is kept for the judges. With
        ``trace`` one whole block, drawn from the first ``min_blocks``,
        runs under the profiler."""
        least = int(self.traffic["min_blocks"])
        self.profiled = int(rng.integers(least)) if trace else None
        self.sync()
        t0 = time.perf_counter()
        ends = []
        i = 0
        while True:
            self.keep(i)
            if i == self.profiled:
                with self.profiling():
                    self.run_block()
            else:
                self.run_block()
                self.sync()
            i += 1
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds and i >= least:
                break
        self.window_s = ends[-1] - t0
        self.keep(i)
        self.nblocks = i
        starts = [t0] + ends[:-1]
        return {"window_s": self.window_s, "attempted": i, "failed": 0,
                "blocks": i, "sweeps": i * self.block,
                "updates": i * self.block * self.n,
                "each_s": [b - a for a, b in zip(starts, ends)]}

    def replay(self, b, judges, judged=None, count=False):
        """Block ``b`` again from its start; each judge is fed the sweeps
        in ``judged`` (every sweep where None) and, with ``count``, every
        other sweep for its count only. Returns the state at the block's
        end."""
        state, th, ld = self.snaps[b]
        gen = torch.Generator(device=self.device)
        gen.set_state(state)
        th = tuple(x.clone() for x in th) if len(th) > 1 else th[0].clone()
        ld = tuple(x.clone() for x in ld)
        for s in range(self.block):
            full = judged is None or s in judged
            if full or count:
                st = gen.get_state()
                inp = (clone(leaves(th)), tuple(x.clone() for x in ld))
            th, ld = self.sweep(gen, th, ld)
            if full or count:
                out = (clone(leaves(th)), tuple(x.clone() for x in ld))
                for j in judges:
                    j.sweep(inp, st, out, full)
        return gen.get_state(), leaves(th), ld

    def judged_sweeps(self, rng):
        k = min(int(self.traffic["judged_sweeps"]), self.block)
        return set(rng.choice(self.block, size=k, replace=False).tolist())

    def judge(self, rng, walkers, controls=(False,)):
        """Readings of the blocks judged: the window's last block (it ends
        in the population after the window) and the profiled one; each
        replayed whole, its judges fed together, and tied bit for bit to
        the state the window reached (in the program's readings);
        ``judged_sweeps`` of its sweeps (drawn by ``rng``) held to the
        reference, and the profiled block's every sweep counted. The
        first block's judges also hold the init to the reference."""
        picks = {self.nblocks - 1}
        if self.profiled is not None:
            picks.add(self.profiled)
        out = []
        for b in sorted(picks):
            js = [AISJudge(self.cfg, self.model, rng=rng, walkers=walkers,
                           control=c) for c in controls]
            if not out:
                r = self.init
                for j in js:
                    j.init(r["pushed"], r["state"], r["costs"], r["lds"])
            state, th, ld = self.replay(b, js, self.judged_sweeps(rng),
                                        count=b == self.profiled)
            _, th_w, ld_w = self.snaps[b + 1]
            for x, y in zip(list(th) + list(ld), list(th_w) + list(ld_w)):
                js[0].r.mismatch("replayed block", (x != y).sum())
            out.append((b, js))
        return out

    def work(self, judge):
        from metrics import _counts as c
        return [("k6",) + c.ais_half(self.mod, self.cfg, self.n // 2, nin)
                for nin in judge.inside]
