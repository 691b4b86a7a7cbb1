"""kissabc_tpu_torch's checkpoint/resume, ``smc_stepped``, ``IterLog`` and
``trace``, mirroring tests/test_checkpoint_logging.py on the CPU: the
``.npz`` round trip, the missing-leaf message of the JAX package,
``smc_stepped`` equal to ``smc`` for the same key (on the split and the
fused-sweep paths), a run stopped at a checkpoint and resumed equal to
one that never stopped, the log records, and a profiler trace.
"""

import io
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu.utils import checkpoint as jax_ckpt
from kissabc_tpu_torch import models
from kissabc_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dirac(x):
    return torch.abs(x * x + 1 - 1.5)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(5.0),
            "b": (torch.ones((2, 3)), torch.tensor(7, dtype=torch.int32))}
    p = str(tmp_path / "state.npz")
    ckpt.save(p, tree, {"iteration": 3})
    loaded, meta = ckpt.load(p, tree)
    assert meta == {"iteration": 3}
    np.testing.assert_array_equal(loaded["a"].numpy(), np.arange(5.0))
    np.testing.assert_array_equal(loaded["b"][0].numpy(), np.ones((2, 3)))
    assert int(loaded["b"][1]) == 7
    assert loaded["b"][1].dtype == torch.int32
    assert not os.path.exists(p + ".tmp.npz")


def test_checkpoint_leaf_names_and_missing_leaf_message_match_jax(tmp_path):
    """The same tree saved by both packages has the same leaf names, and
    a template with a leaf the file lacks raises the JAX message."""
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    ckpt.save(tp, {"a": torch.zeros(3), "c": (torch.ones(2),)})
    jax_ckpt.save(jp, {"a": jnp.zeros(3), "c": (jnp.ones(2),)})
    with np.load(tp) as t, np.load(jp) as j:
        assert sorted(t.files) == sorted(j.files)
    with pytest.raises(KeyError) as jerr:
        jax_ckpt.load(jp, {"a": jnp.zeros(3), "b": jnp.zeros(1)})
    with pytest.raises(KeyError) as terr:
        ckpt.load(tp, {"a": torch.zeros(3), "b": torch.zeros(1)})
    assert str(terr.value) == str(jerr.value)


def test_checkpoint_restores_the_generator(tmp_path):
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    p = str(tmp_path / "g.npz")
    ckpt.save(p, {"key": gen, "x": torch.ones(2)})
    want = torch.rand(4, generator=gen)
    other = torch.Generator().manual_seed(0)
    loaded, _ = ckpt.load(p, {"key": other, "x": torch.zeros(2)})
    assert loaded["key"] is other
    assert torch.equal(torch.rand(4, generator=other), want)


def test_smc_stepped_matches_smc_and_resumes(tmp_path):
    """tests/test_checkpoint_logging.py:27-50 through the port."""
    pri = kt.Normal(1, 0.2)
    buf = io.StringIO()
    log = kt.IterLog(stream=buf)
    p = str(tmp_path / "smc.npz")
    res = kt.smc_stepped(pri, _dirac, epstol=0.1, checkpoint_path=p,
                         checkpoint_every=2, log=log, key=7, device="cpu")
    assert res.P.approx(0.707, atol=0.05)
    assert len(log.records) == res.iterations
    assert log.records[0]["iteration"] == 1
    assert {"eps", "ess", "accepted"} <= set(log.records[0])
    assert '"iteration": 1' in buf.getvalue()

    # same key => the same result as smc, bit for bit
    res2 = kt.smc(pri, _dirac, epstol=0.1, key=7, device="cpu")
    np.testing.assert_array_equal(res.P.particles, res2.P.particles)
    np.testing.assert_array_equal(res.C, res2.C)
    assert res.iterations == res2.iterations and res.eps == res2.eps

    # resuming from the last checkpoint finishes at the same place
    res3 = kt.smc_stepped(pri, _dirac, epstol=0.1, checkpoint_path=p,
                          resume=True, key=7, device="cpu")
    assert res3.P.approx(0.707, atol=0.05)
    assert res3.iterations >= res.iterations - 2
    np.testing.assert_array_equal(res3.C, res.C)


def _stop_and_resume(tmp_path, name, **kw):
    """(uninterrupted, stopped at the first checkpoint then resumed)."""
    p = str(tmp_path / f"{name}.npz")
    whole = kt.smc_stepped(checkpoint_path=str(tmp_path / f"{name}-w.npz"),
                           checkpoint_every=10, **kw)
    with pytest.warns(RuntimeWarning, match="max_iters=10"):
        cut = kt.smc_stepped(checkpoint_path=p, checkpoint_every=10,
                             **{**kw, "max_iters": 10})
    assert cut.iterations == 10
    log = kt.IterLog(enabled=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        resumed = kt.smc_stepped(checkpoint_path=p, checkpoint_every=10,
                                 resume=True, log=log, **kw)
    assert log.records[0]["iteration"] == 11
    return whole, resumed


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    whole, resumed = _stop_and_resume(
        tmp_path, "dirac", prior=kt.Normal(1, 0.2), cost=_dirac,
        epstol=0.1, key=3, device="cpu")
    assert whole.iterations == resumed.iterations > 10
    np.testing.assert_array_equal(whole.C, resumed.C)
    assert whole.eps == resumed.eps


def test_stepped_fused_sweep_resumes_and_equals_smc(tmp_path):
    """The generic fused path (streaming cost for the init, fused sweep
    for the moves), as chip_smoke.py's smc-stepped-resume runs it."""
    prior, draw, reduce_cost = models.flagship()
    cost = kt.make_streaming_moment_cost(draw, reduce_cost, ndraws=100)
    sweep = kt.make_fused_smc_sweep(prior, draw, reduce_cost, ndraws=100)
    kw = dict(prior=prior, cost=cost, cost_vectorized=True,
              sweep_fused=sweep, nparticles=128, epstol=0.2, key=2,
              device="cpu")
    whole, resumed = _stop_and_resume(tmp_path, "fused", **kw)
    ref = kt.smc(**kw)
    for r in (resumed, ref):
        np.testing.assert_array_equal(whole.C, r.C)
        assert whole.eps == r.eps and whole.iterations == r.iterations


def test_stepped_validation():
    with pytest.raises(TypeError, match="object"):
        kt.smc_stepped(kt.Normal(1, 0.2), _dirac, mesh=object(),
                       device="cpu")
    with pytest.raises(ValueError, match="alpha"):
        kt.smc_stepped(kt.Normal(1, 0.2), _dirac, alpha=0.0, device="cpu")


def test_iterlog_records():
    buf = io.StringIO()
    log = kt.IterLog(stream=buf)
    log.emit(iteration=1, eps=0.5)
    assert log.records[0]["iteration"] == 1
    assert "eps" in buf.getvalue()
    quiet = kt.IterLog(stream=buf, enabled=False)
    quiet.emit(iteration=2)
    assert quiet.records[0]["iteration"] == 2 and '"iteration": 2' \
        not in buf.getvalue()


def test_profiler_trace_smoke(tmp_path):
    """``trace`` wraps a block in torch.profiler and writes a Chrome
    trace holding the block's ops, here a short smc run."""
    logdir = str(tmp_path / "trace")
    with kt.trace(logdir) as d:
        with pytest.warns(RuntimeWarning, match="max_iters"):
            res = kt.smc(kt.Normal(1, 0.2), _dirac, nparticles=128,
                         max_iters=3, key=0, device="cpu")
    assert d == logdir and res.C.shape == (128,)
    path = os.path.join(logdir, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert "aten::" in f.read()
