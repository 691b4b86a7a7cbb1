"""Several processes, one mesh — the PyTorch counterpart of
``kissabc_tpu/parallel/distributed.py``.

Every process runs the same script: it starts the process group, builds
one global mesh over every process's local devices (process-major), and
calls the sampler with it. Each process holds its own shards; the run's
generator is the same in every process (the same ``key``), so every
process draws the same population-wide numbers and keeps its blocks.
The collectives of ``parallel/mesh.py`` go through ``torch.distributed``
(nccl between cards, gloo on the CPU)::

    from kissabc_tpu_torch.parallel import distributed as dist
    dist.initialize()                   # reads torchrun's variables
    mesh = dist.global_mesh(walker=dist.process_info()["global_devices"])
    res = kt.smc(prior, cost, nparticles=1 << 20, mesh=mesh)

launched as ``torchrun --nproc-per-node=K script.py`` on a host with K
cards (one card a process). With no cluster, ``initialize`` is a no-op
and ``global_mesh`` a mesh over this process's cards (or over the
devices named to ``initialize``, e.g. ``device="cpu"``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import Mesh, make_mesh

# this process's devices, set by ``initialize``
_local = {"devices": None}


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               device: str | None = None, local_devices=None) -> bool:
    """Start the process group. The arguments, or else ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` as ``torchrun`` sets
    them; ``coordinator_address`` is ``host:port``. Returns True when a
    group of several processes (or a one-rank group asked for by its
    arguments) was started, False for the single-host no-op (which
    only records ``device="cpu"`` or ``local_devices`` for
    ``global_mesh``).

    The backend is nccl when the process has a card, gloo when
    ``device="cpu"``. ``local_devices``: this process's shard devices
    (default its card, ``LOCAL_RANK`` of them; ``["cpu"]`` on gloo);
    they may repeat a device, as ``make_mesh(devices=...)``."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    cpu = device is not None and torch.device(device).type == "cpu"
    if coordinator_address is None and num_processes is None:
        if cpu or local_devices is not None:   # asked for by name
            _local["devices"] = [torch.device(d) for d in
                                 (local_devices or ["cpu"])]
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize needs the coordinator address, the number of "
            "processes and this process's id (or MASTER_ADDR/MASTER_PORT, "
            "WORLD_SIZE and RANK)")
    import torch.distributed as dist
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(
            "initialize: no CUDA device for the nccl backend; pass "
            "device='cpu' for gloo")
    if local_devices is None:
        if cpu:
            local_devices = ["cpu"]
        else:
            local = int(env.get("LOCAL_RANK", process_id
                                % torch.cuda.device_count()))
            local_devices = [f"cuda:{local}"]
    local_devices = [torch.device(d) for d in local_devices]
    if not cpu:
        torch.cuda.set_device(local_devices[0])
    dist.init_process_group(
        "gloo" if cpu else "nccl", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        **({} if cpu else {"device_id": local_devices[0]}))
    _local["devices"] = local_devices
    dist.barrier()
    return True


def _local_devices():
    """This process's devices: those ``initialize`` was given, else its
    cards (none without a card: a CPU mesh is asked for by name)."""
    if _local["devices"] is not None:
        return _local["devices"]
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return []


def global_mesh(**axes) -> Mesh:
    """A mesh over every process's local devices, process-major; the
    sizes must multiply to the global device count. Without a process
    group, ``make_mesh`` over this process's devices: its cards, or the
    devices named to ``initialize`` (``device="cpu"`` or
    ``local_devices=``); without either it raises, as ``make_mesh``."""
    if not _initialized():
        if _local["devices"] is None:
            return make_mesh(**axes)
        return make_mesh(devices=_local["devices"], **axes)
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    local = _local_devices()
    counts = [None] * world
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"every process needs the same number of local "
                         f"devices, got {counts}")
    sizes = tuple(int(v) for v in axes.values())
    total = world * len(local)
    if int(np.prod(sizes)) != total:
        raise ValueError(f"mesh axes {axes} must multiply to the global "
                         f"device count {total}")
    devs = np.empty(total, dtype=object)
    ranks = np.empty(total, dtype=np.int64)
    for p in range(world):
        for i, d in enumerate(local):
            # another process's devices: only its owner addresses them
            devs[p * len(local) + i] = d
            ranks[p * len(local) + i] = p
    return Mesh(devs.reshape(sizes), tuple(axes), ranks.reshape(sizes), rank,
                distributed=True)


def process_info() -> dict:
    local = len(_local_devices())
    if not _initialized():
        return {"process_index": 0, "process_count": 1,
                "local_devices": local, "global_devices": local}
    import torch.distributed as dist
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world,
            "local_devices": local, "global_devices": world * local}


def shutdown() -> None:
    """Destroy the process group (a no-op without one)."""
    if _initialized():
        import torch.distributed as dist
        dist.destroy_process_group()
    _local["devices"] = None
