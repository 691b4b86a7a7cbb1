"""How a CUDA graph is recorded and replayed on one card; what is
recorded is the caller's (``core/smc.py`` ``_IterGraphs``). Every graph
takes its memory from one pool a process (``_POOL``): a graph keeps
nothing live between its replays and the graphs run one after another on
one stream, so a capture may take the blocks that earlier ones freed. The
last graphs are kept (``_LAST``) until the next ones are made, so that
their pool's memory lives on, and every capture records on one side
stream a device (``_STREAMS``), as the allocator hands a free block only
to the stream that freed it: else each solve would take new memory
(``cudaMalloc``)."""

import gc

import torch

from .logging import add_counts, counters, counts

_POOL = []
_LAST = []
_STREAMS = {}


def _graph_pool():
    if not _POOL:
        _POOL.append(torch.cuda.graph_pool_handle())
    return _POOL[0]


def _capture_stream(device):
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


class _Captured:
    """The CUDA work of ``fn()`` recorded once as a CUDA graph on the
    device's capture stream, the generators ``gens`` registered with it
    (each replay advances them by the graph's draws, as running ``fn``
    would), and replayed on the current stream. The counters that ``fn``'s Python
    moved while it was recorded are taken back, and added at each
    replay; each replay also counts one ``graph_replays``."""

    def __init__(self, fn, device, gens=()):
        self.graph = torch.cuda.CUDAGraph()
        for g in gens:
            self.graph.register_generator_state(g)
        before = counts()
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        # a collection while recording could destroy an earlier graph,
        # which a capture does not permit
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool=_graph_pool(),
                                         capture_error_mode="thread_local")
                try:
                    fn()
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(device).wait_stream(side)
        self.delta = {k: v - before[k] for k, v in counts().items()
                      if v != before[k]}
        add_counts({k: -v for k, v in self.delta.items()})

    def replay(self):
        self.graph.replay()
        add_counts(self.delta)
        counters["graph_replays"] += 1


def _capture(device, *calls):
    """A ``_Captured`` of each ``(fn, gens)``, in order: the last graphs."""
    _LAST[:] = [_Captured(fn, device, gens) for fn, gens in calls]
    return list(_LAST)
