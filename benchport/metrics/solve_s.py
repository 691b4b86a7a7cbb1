"""Seconds a solve: the window, from the start of the first timed solve
to the end of the last, over the solves finished in it."""


def read(ctx):
    w = ctx["window"]
    return w["window_s"] / w["solves"] if w.get("solves") else None
