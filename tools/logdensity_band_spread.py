"""The spread, over keys, of the statistics that
``test_common_logdensity_vectorized`` bands, in both packages on the CPU.

The test (``tests/test_vectorized_cost.py`` and its port mirror
``tests/test_torch_vectorized_cost.py``) samples a standard normal in
two dimensions with ``CommonLogDensity`` and a batched log-density,
``AIS(32)``, 500 samples, ``ntransitions=5``, ``discard_initial=500``,
and bands the two means and the first coordinate's std. This script
runs that sample at keys ``0..K-1`` in each package and prints, per
package, the standard deviation over keys of the means and of the std,
their largest deviations, and the band of 4 sd of the larger spread.

    python tools/logdensity_band_spread.py [--keys 20] [--out FILE.json]

About 2.5 min on 8 CPU cores, almost all of it the JAX package.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _jax_run(key):
    import jax
    import jax.numpy as jnp
    import kissabc_tpu as ka
    D = ka.CommonLogDensity(
        2, lambda k: jax.random.normal(k, (2,)),
        lambda xs, key: -0.5 * jnp.sum(xs * xs, axis=-1),
        lpi_vectorized=True)
    x, y = ka.sample(D, ka.AIS(32), 500, ntransitions=5,
                     discard_initial=500, key=key)
    return x.mean(), y.mean(), x.std()


def _torch_run(key):
    import torch
    import kissabc_tpu_torch as kt
    D = kt.CommonLogDensity(
        2, lambda g: torch.randn(2, generator=g, device=g.device),
        lambda xs, gen: -0.5 * torch.sum(xs * xs, dim=-1),
        lpi_vectorized=True)
    x, y = kt.sample(D, kt.AIS(32), 500, ntransitions=5,
                     discard_initial=500, key=key, device="cpu")
    return x.mean(), y.mean(), x.std()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = {}
    for name, run in (("kissabc_tpu", _jax_run),
                      ("kissabc_tpu_torch", _torch_run)):
        t0 = time.time()
        a = np.array([run(k) for k in range(args.keys)], np.float64)
        means = a[:, :2].reshape(-1)
        out[name] = {
            "x_mean": a[:, 0].tolist(), "y_mean": a[:, 1].tolist(),
            "x_std": a[:, 2].tolist(),
            "sd_of_means": float(means.std(ddof=1)),
            "max_abs_mean": float(np.abs(means).max()),
            "sd_of_x_std": float(a[:, 2].std(ddof=1)),
            "max_abs_x_std_minus_1": float(np.abs(a[:, 2] - 1.0).max()),
            "seconds": time.time() - t0}
        print(name, {k: v for k, v in out[name].items()
                     if not isinstance(v, list)}, flush=True)
    sd = max(v["sd_of_means"] for v in out.values())
    out["band_4sd_of_means"] = 4.0 * sd
    print(json.dumps({"keys": args.keys, "band_4sd_of_means": 4.0 * sd}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
