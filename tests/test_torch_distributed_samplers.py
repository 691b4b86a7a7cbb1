"""Two real processes, one walker mesh, for the samplers beside smc: each
process holds 2 CPU shards of ``global_mesh(walker=4)`` on a gloo process
group (``parallel/distributed.py``) and runs AIS (the roll scheme: the
partner rolls as point-to-point permutes between the processes) and
ABCDE (the joined costs and parents as all-gathers); both processes
print the same digests, and they equal the one-process mesh of 4 CPU
shards and the run on one device bit for bit. Each worker has its own
timeout. ~15 s.
"""

import hashlib
import inspect
import os
import socket
import subprocess
import sys
import textwrap
import threading

import numpy as np
import torch

import kissabc_tpu_torch as kt
from kissabc_tpu_torch.parallel.mesh import make_mesh
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    assert mesh.local() == [2 * rank, 2 * rank + 1]
    for name, res in _runs(mesh):
        print(f"RESULT {name} {_digest(res)}", flush=True)
    dist.shutdown()
""")


def _runs(mesh=None):
    """(name, particles) of each sampler on ``mesh``, or on one device."""
    where = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    abc = kt.ApproxKernelizedPosterior(
        kt.Normal(1, 0.2), lambda x: torch.abs(x * x + 1 - 1.5), 0.001)
    ais = kt.sample(abc, kt.AIS(64), 128, discard_initial=256, key=4,
                    partner_scheme="roll", **where)

    def cost(x, g):
        return torch.abs(x + 0.1 * torch.randn((), generator=g,
                                               device=g.device))

    de = kt.ABCDE(kt.Uniform(-10, 10), cost, 0.1, nparticles=128,
                  generations=40, verbose=False, key=7, **where)
    return [("ais", ais.particles), ("abcde", de.P.particles)]


def _digest(x):
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_samplers(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text("import hashlib, numpy as np, torch\n"
                      "import kissabc_tpu_torch as kt\n"
                      + inspect.getsource(_runs) + inspect.getsource(_digest)
                      + WORKER)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), port, REPO],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
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
    assert len(outs[0]) == 2 and outs[0] == outs[1], outs
    one_process = [f"RESULT {n} {_digest(x)}"
                   for n, x in _runs(make_mesh(walker=4,
                                               devices=["cpu"] * 4))]
    one_device = [f"RESULT {n} {_digest(x)}" for n, x in _runs()]
    assert outs[0] == one_process == one_device
