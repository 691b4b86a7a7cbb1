"""Walker updates a second: walkers times sweeps over the window of
whole blocks of sweeps run back to back."""


def read(ctx):
    w = ctx["window"]
    return w["updates"] / w["window_s"] if w.get("updates") else None
