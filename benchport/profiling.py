"""The profiled span as the metric readers take it, and the breakdown a
traced run prints: the device operations that took most time, and the
longest idle gaps of the card by what the host was doing in them."""

from __future__ import annotations

import bisect

from metrics._trace import busy_us


def summarize(prof, torch):
    """``{"ops": [(name, start_us, end_us)], "window_s", "busy_s"}`` of a
    ``torch.profiler`` run, and the host's operations ``(start, end,
    name)`` in it."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            dev.append((e.name, s, t))
        else:
            host.append((s, t, e.name))
    if not dev:
        return None, host
    lo = min([s for _, s, _ in dev] + [s for s, _, _ in host])
    hi = max([t for _, _, t in dev] + [t for _, t, _ in host])
    busy = busy_us([(s, t) for _, s, t in dev])
    return {"ops": dev, "window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "span": (lo, hi)}, host


def _gaps(ops, lo, hi):
    """The card's idle intervals inside ``(lo, hi)``."""
    out, end = [], lo
    for _, s, t in sorted(ops, key=lambda o: o[1]):
        if s > end:
            out.append((end, s))
        end = max(end, t)
    if hi > end:
        out.append((end, hi))
    return out


def _label(host, starts, mid):
    """The innermost host operation running at time ``mid``."""
    best = None
    i = bisect.bisect_right(starts, mid)
    for s, t, name in reversed(host[max(0, i - 4000):i]):
        if t >= mid and (best is None or t - s < best[0]):
            best = (t - s, name)
    return best[1] if best else "python (between operations)"


# entries of each list of the breakdown (the contract's most), and the
# longest idle gaps labelled
TOP, GAPS = 10, 200


def breakdown(trace, host):
    """The ``breakdown`` of a traced run's result line: seconds by device
    operation name, and idle seconds by the host operation that ran in
    the middle of each of the ``GAPS`` longest idle gaps."""
    by_op = {}
    for name, s, t in trace["ops"]:
        by_op[name] = by_op.get(name, 0.0) + (t - s) / 1e6
    host = sorted(host)
    starts = [h[0] for h in host]
    idle = sorted(_gaps(trace["ops"], *trace["span"]),
                  key=lambda g: g[0] - g[1])[:GAPS]
    by_host = {}
    for a, b in idle:
        name = _label(host, starts, (a + b) / 2)
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
    first = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    longest = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], v] for n, v in first],
            "idle_gaps": [[n[:120], v] for n, v in longest]}
