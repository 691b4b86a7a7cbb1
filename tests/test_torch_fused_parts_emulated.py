"""The partners-given forms of kernels #6 (``fused_ais_sweep_kernel``,
``kissabc_tpu_torch/csrc/generic.cuh``) and #9
(``fused_tempered_sweep_kernel``, ``csrc/tempered.cuh``), the forms a
shard of a walker mesh launches, compiled for the host with ``g++``
against the emulation in ``tests/host_cuda/cuda_runtime.h`` and called
through their entry points ``kt_fused_ais_sweep_parts`` and
``kt_fused_tempered_sweep_parts``:

- given the snapshot's own rolls (the other half rolled by each of the
  six shifts the snapshot form derives from the same words), the
  partner form gives the snapshot form's outputs bit for bit, on Philox
  and stub bits;
- given six other partner sets (permutations of the other half, so a
  partner read from the wrong set or row shows), it agrees with the
  plain version ``half_plain(..., partners=...)``: commit masks equal
  but where the accept's margin lies within 1e-4, committed values
  within the JAX golden tolerance (rtol 2e-4, atol 2e-5), uncommitted
  walkers untouched bit for bit.

Skipped without a host C++ compiler (~20 s with the four g++ builds).
"""

import ctypes

import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from host_cuda.build import build_program
from kissabc_tpu_torch import models
from kissabc_tpu_torch.ops import fused_ais as FA
from kissabc_tpu_torch.ops._build import GEN_SIGNATURES

RTOL, ATOL, BORDER = 2e-4, 2e-5, 1e-4
H, NDRAWS, CHUNK = 128, 64, 32


def _ptrs(ts):
    return ctypes.cast((ctypes.c_void_p * len(ts))(
        *[t.data_ptr() for t in ts]), ctypes.c_void_p)


def _lib(tmp_path, source):
    (tmp_path / "unit.cpp").write_text(source)
    lib = ctypes.CDLL(str(build_program(tmp_path, None, "unit.cpp",
                                        shared=True)))
    for name, types in GEN_SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = types
    return lib


def _words(seed):
    return FA.uint32_words(torch.Generator().manual_seed(seed), 7)


def _shard_words(words):
    """Six zero shift words (unread by the partner form), then the seed."""
    return torch.cat([torch.zeros(6, dtype=torch.int64), words[6:]])


def _rolled(comp, shifts):
    return [torch.roll(c, -int(r), 0) for c in comp for r in shifts]


def _other_partners(comp, seed):
    g = torch.Generator().manual_seed(seed)
    return [c[torch.randperm(c.shape[0], generator=g)] for c in comp
            for _ in range(6)]


def _check_against_plain(got, want, inputs, margin):
    committed = [np.any([o.numpy() != x.numpy() for o, x in zip(outs, inputs)],
                        axis=0) for outs in (got, want)]
    border = margin.abs().numpy() < BORDER
    assert ((committed[0] == committed[1]) | border).all()
    both = committed[0] & committed[1]
    assert int(both.sum()) > 3
    for g, w, x in zip(got, want, inputs):
        np.testing.assert_allclose(g.numpy()[both], w.numpy()[both],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(g.numpy()[~committed[0]],
                                      x.numpy()[~committed[0]])


@pytest.mark.parametrize("bits", ["hw", "stub"])
def test_ais_partner_form(tmp_path, bits):
    prior, draw, _ = models.flagship()
    sw = kt.make_fused_ais_sweep(prior, draw, lambda th, m: m[0] + 10.0 * m[1],
                                 scale=30.0, ndraws=NDRAWS, chunk=CHUNK,
                                 block=128, walker_tiles=1, bits=bits)
    lib = _lib(tmp_path, sw.unit.source)
    rng = np.random.default_rng(3)
    th = [torch.tensor(rng.uniform(1.5, 2.5, 2 * H), dtype=torch.float32),
          torch.tensor(rng.uniform(0.01, 0.1, 2 * H), dtype=torch.float32)]
    upd, comp = [x[:H] for x in th], [x[H:] for x in th]
    lp = prior.logpdf_tree(prior.push_tree(tuple(upd))).to(torch.float32)
    ll = torch.tensor(rng.uniform(-20, -1, H), dtype=torch.float32)
    words = _words(4)
    shifts = FA.rot_shifts6(words[:6], H)

    def launch(parts, w, walkers=64, threads=64, lanes=1):
        oth = [torch.full((H,), -7.0) for _ in upd]
        olp, oll = torch.full((H,), -7.0), torch.full((H,), -7.0)
        args = (_ptrs(upd), lp.data_ptr(), ll.data_ptr(), _ptrs(comp),
                w.data_ptr(), _ptrs(oth), olp.data_ptr(), oll.data_ptr(), H,
                NDRAWS, sw.fconsts.ctypes.data_as(ctypes.c_void_p),
                int(bits == "stub"), sw._sb_rows(H), CHUNK, walkers, threads,
                lanes, None)
        if parts is None:
            err = lib.kt_fused_ais_sweep(*args)
        else:
            err = lib.kt_fused_ais_sweep_parts(*args, _ptrs(parts))
        assert err == 0
        return oth + [olp, oll]

    snapshot = launch(None, words)
    same = launch(_rolled(comp, shifts), _shard_words(words))
    assert all(torch.equal(a, b) for a, b in zip(snapshot, same))
    lanes4 = launch(_rolled(comp, shifts), _shard_words(words), 32, 128, 4)
    assert all(torch.equal(a, b) for a, b in zip(snapshot, lanes4))
    parts = _other_partners(comp, 5)
    got = launch(parts, _shard_words(words))
    want = sw.half_plain(upd, lp, ll, None, None, words[6:], terms=True,
                         partners=parts)
    _check_against_plain(got, list(want[0]) + [want[1], want[2]],
                         upd + [lp, ll], want[3][1])


@pytest.mark.parametrize("bits", ["hw", "stub"])
def test_tempered_partner_form(tmp_path, bits):
    prior, ll_elem, _, _ = models.conjugate_normal()
    sw = kt.make_fused_tempered_sweep(prior, ll_elem, block=128,
                                      walker_tiles=1, bits=bits)
    lib = _lib(tmp_path, sw.unit.source)
    g = torch.Generator().manual_seed(2)
    th = torch.randn(2 * H, generator=g)
    upd, comp = [th[:H]], [th[H:]]
    lp, ll = prior.logpdf(upd[0]).float(), ll_elem(upd[0]).float()
    lam = torch.tensor([0.4])
    words = _words(6)
    shifts = FA.rot_shifts6(words[:6], H)

    def launch(parts, w):
        oth = [torch.full((H,), -7.0)]
        olp, oll = torch.full((H,), -7.0), torch.full((H,), -7.0)
        args = (_ptrs(upd), lp.data_ptr(), ll.data_ptr(), _ptrs(comp),
                w.data_ptr(), lam.data_ptr(), _ptrs(oth), olp.data_ptr(),
                oll.data_ptr(), H, sw.fconsts.ctypes.data_as(ctypes.c_void_p),
                int(bits == "stub"), sw._sb_rows(H), None)
        if parts is None:
            err = lib.kt_fused_tempered_sweep(*args)
        else:
            err = lib.kt_fused_tempered_sweep_parts(*args, _ptrs(parts))
        assert err == 0
        return oth + [olp, oll]

    snapshot = launch(None, words)
    same = launch(_rolled(comp, shifts), _shard_words(words))
    assert all(torch.equal(a, b) for a, b in zip(snapshot, same))
    parts = _other_partners(comp, 7)
    got = launch(parts, _shard_words(words))
    want = sw.half_plain(upd, lp, ll, None, None, words[6:], lam, terms=True,
                         partners=parts)
    _check_against_plain(got, list(want[0]) + [want[1], want[2]],
                         upd + [lp, ll], want[3][1])
