"""Two real processes, one walker mesh, mirroring tests/test_distributed.py:
each process holds 2 CPU shards of ``global_mesh(walker=4)`` on a gloo
process group (``parallel/distributed.py``) and runs the same sharded
smc; both print the same eps, mean and particles' digest, the posterior
is within 0.05 of 0.707, and the result equals the one-process mesh of 4
CPU shards bit for bit, for the default scheme, the roll scheme (the
point-to-point permutes) and systematic resampling. Each worker has its
own timeout. ~15 s.
"""

import hashlib
import os
import socket
import subprocess
import sys
import textwrap
import threading

import pytest
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.parallel import distributed as dist
from kissabc_tpu_torch.parallel.mesh import make_mesh
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ({}, {"partner_scheme": "roll"}, {"resample": "systematic"})

WORKER = textwrap.dedent("""
    import hashlib, sys
    rank, port, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, repo)
    import torch
    import kissabc_tpu_torch as kt
    from kissabc_tpu_torch.parallel import distributed as dist
    assert dist.initialize(f"localhost:{port}", 2, rank, device="cpu",
                           local_devices=["cpu", "cpu"])
    mesh = dist.global_mesh(walker=4)
    info = dist.process_info()
    assert info == {"process_index": rank, "process_count": 2,
                    "local_devices": 2, "global_devices": 4}, info
    assert mesh.local() == [2 * rank, 2 * rank + 1]
    pri = kt.Normal(1, 0.2)
    cost = lambda x: torch.abs(x * x + 1 - 1.5)
    for i, kw in enumerate(%r):
        res = kt.smc(pri, cost, nparticles=256, epstol=0.1, mesh=mesh,
                     key=2, **kw)
        digest = hashlib.sha256(res.P.particles.tobytes()).hexdigest()
        print(f"RESULT {i} {res.eps!r} {float(res.P.mean())!r} "
              f"{res.iterations} {digest}", flush=True)
    dist.shutdown()
""") % (CASES,)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _line(i, res):
    digest = hashlib.sha256(res.P.particles.tobytes()).hexdigest()
    return (f"RESULT {i} {res.eps!r} {float(res.P.mean())!r} "
            f"{res.iterations} {digest}")


def test_two_process_distributed_smc(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), port, REPO],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    # drain both at once: one blocked in a collective must not stall the
    # other's pipe
    results = [None, None]

    def drain(i):
        try:
            results[i] = procs[i].communicate(timeout=240)
        except subprocess.TimeoutExpired:
            procs[i].kill()
            results[i] = procs[i].communicate()

    threads = [threading.Thread(target=drain, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(250)
    outs = []
    for i, p in enumerate(procs):
        out, err = results[i]
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
        outs.append([line for line in out.splitlines()
                     if line.startswith("RESULT")])
    assert len(outs[0]) == len(CASES) and outs[0] == outs[1], outs
    mesh = make_mesh(walker=4, devices=["cpu"] * 4)
    pri = kt.Normal(1, 0.2)

    def cost(x):
        return torch.abs(x * x + 1 - 1.5)

    for i, kw in enumerate(CASES):
        res = kt.smc(pri, cost, nparticles=256, epstol=0.1, mesh=mesh, key=2,
                     **kw)
        assert abs(float(res.P.mean()) - 0.707) < 0.05
        assert outs[0][i] == _line(i, res)


def test_single_host_is_a_no_op(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert dist.initialize() is False
    info = dist.process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1
    if torch.cuda.is_available():
        mesh = dist.global_mesh(walker=1)
        assert mesh.size == 1 and not mesh.distributed
        assert mesh.home == torch.device("cuda", 0)
    else:   # no quiet CPU mesh: the CPU is asked for by name
        assert info["local_devices"] == 0
        with pytest.raises(ValueError, match="mesh needs 1 devices, have 0"):
            dist.global_mesh(walker=1)
    try:
        assert dist.initialize(device="cpu") is False
        mesh = dist.global_mesh(walker=1)
        assert mesh.size == 1 and not mesh.distributed
        assert mesh.home == torch.device("cpu")
    finally:
        dist.shutdown()
