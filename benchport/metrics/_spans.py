"""The program's own spans of the profiled solve or block, as the readers
of ``program_span`` and ``program_counter`` metrics take them.

``kissabc_tpu_torch.utils.logging`` records a span for each phase of the
smc loop and of the fused AIS sweep while a ``torch.profiler`` records,
so the profiled solve or block leaves its spans there. The reader takes
the module that ``run.py`` loaded from the checkout out of
``sys.modules`` and never imports the package itself; a package that
records no spans gives nothing to read (None).

A span is a dict with ``name``, ``id``, ``parent``, ``root``,
``start_ns``, ``end_ns`` and ``counts`` (the counters that moved inside
it). A ``sync`` span is the host waiting for the card: a read of a
tensor's value (``host_syncs``) or a blocking copy to it
(``host_copies``)."""

import sys

MODULE = "kissabc_tpu_torch.utils.logging"


def recorded():
    """Every span the program recorded, or None."""
    spans = getattr(sys.modules.get(MODULE), "spans", None)
    return spans() if callable(spans) else None


def solve():
    """The spans under the single ``smc.solve`` root (the root first), or
    None where there is not exactly one."""
    rec = recorded() or []
    roots = [s for s in rec if s["name"] == "smc.solve"
             and s["parent"] is None]
    if len(roots) != 1:
        return None
    rid = roots[0]["id"]
    return [roots[0]] + [s for s in rec if s["root"] == rid
                         and s["id"] != rid]


def named(spans, *names):
    return [s for s in spans if s["name"] in names]


def seconds(spans):
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e9


def syncs_inside(spans, within):
    """The ``sync`` spans of ``spans`` that lie inside one of ``within``
    (a child, or deeper)."""
    by_id = {s["id"]: s for s in spans}
    ids = {s["id"] for s in within}
    out = []
    for s in spans:
        if s["name"] != "sync":
            continue
        p = s["parent"]
        while p is not None and p not in ids:
            p = by_id[p]["parent"] if p in by_id else None
        if p is not None:
            out.append(s)
    return out


def host_seconds(spans, *names):
    """Seconds of the spans ``names`` less their ``sync`` spans: the
    host's own time in them."""
    within = named(spans, *names)
    return seconds(within) - seconds(syncs_inside(spans, within))


def per_iteration(value, spans):
    """``value`` over the solve's ``smc.iter`` spans, or None."""
    iters = len(named(spans, "smc.iter"))
    return value / iters if iters else None
