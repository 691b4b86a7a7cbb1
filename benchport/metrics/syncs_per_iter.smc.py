"""Host syncs an smc iteration: the reads of a tensor's value
(``host_syncs``) and the blocking copies to the card (``host_copies``)
that the program counted inside the profiled solve's ``smc.solve``
span, over its ``smc.iter`` spans."""
from metrics import _spans


def read(ctx):
    spans = _spans.solve()
    if spans is None:
        return None
    c = spans[0]["counts"]
    return _spans.per_iteration(
        c.get("host_syncs", 0) + c.get("host_copies", 0), spans)
