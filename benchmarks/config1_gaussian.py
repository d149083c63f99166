"""BASELINE config 1: the README 4-node GaussianNetwork workload —
MLE LinearGaussianCPD fit + slogl + ancestral sampling, 1k rows.

Measures full fit+slogl+sample pipelines per second, compared against a
serial numpy lstsq + logpdf baseline standing in for the reference's
single-threaded Eigen path (reference mle_LinearGaussianCPD.cpp,
BayesianNetwork.hpp:960-1066).

Prints ONE JSON line.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pybnesian_tpu.runtime.config import enable_compile_cache  # noqa: E402

enable_compile_cache()


def make_data(n=1000, seed=1):
    import pandas as pd

    rng = np.random.default_rng(seed)
    a = rng.normal(3, 0.5, n)
    b = 2.5 - 1.3 * a + rng.normal(0, 0.6, n)
    c = -4.4 - 1.1 * a + rng.normal(0, 0.8, n)
    d = 0.5 * b + 0.7 * c + rng.normal(0, 0.4, n)
    return pd.DataFrame({"a": a, "b": b, "c": c, "d": d})


def bench_ours(df, reps=60):
    from pybnesian_tpu import GaussianNetwork

    arcs = [("a", "b"), ("a", "c"), ("b", "d"), ("c", "d")]
    cols = list(df.columns)  # fixed network definition, like the C baseline's
    # pre-extracted column pointers

    def pipeline():
        g = GaussianNetwork(cols, arcs)
        g.fit(df)
        s = float(g.slogl(df))
        g.sample(100, seed=0)
        return s

    pipeline()  # warm (compiles)
    t0 = time.time()
    for _ in range(reps):
        pipeline()
    return reps / (time.time() - t0)


def bench_baseline(df, reps=60):
    """Serial numpy: per-node lstsq fit, normal logpdf, ancestral sample."""
    from scipy.stats import norm

    arcs = {"a": [], "b": ["a"], "c": ["a"], "d": ["b", "c"]}
    mat = {c: df[c].to_numpy() for c in df.columns}
    n = len(df)

    def pipeline():
        total = 0.0
        params = {}
        for v, ps in arcs.items():
            y = mat[v]
            X = np.column_stack([np.ones(n)] + [mat[p] for p in ps])
            beta, *_ = np.linalg.lstsq(X, y, rcond=None)
            resid = y - X @ beta
            var = resid @ resid / (n - len(ps) - 1)
            params[v] = (beta, var)
            total += norm.logpdf(y, X @ beta, np.sqrt(var)).sum()
        rng = np.random.default_rng(0)
        samp = {}
        for v in ["a", "b", "c", "d"]:
            beta, var = params[v]
            mean = beta[0] + sum(
                beta[i + 1] * samp[p] for i, p in enumerate(arcs[v])
            )
            samp[v] = mean + rng.normal(0, np.sqrt(var), 100)
        return total

    pipeline()
    t0 = time.time()
    for _ in range(reps):
        pipeline()
    return reps / (time.time() - t0)


def bench_faithful_c(df, reps=60):
    """Compiled serial stand-in for the reference's Eigen closed-form
    ladder (benchmarks/faithful_c/faithful.cpp, mirrors
    mle_LinearGaussianCPD.hpp:12-69)."""
    from faithful_c import lg_pipeline_rate

    rate, _slogl = lg_pipeline_rate(df, reps)
    return rate


def main():
    df = make_data()
    # interleave ours/baseline rounds: this host is shared, so measuring
    # the two at different moments makes the ratio noise-dominated; paired
    # rounds + median ratio cancels the drift
    ours_rates, ratios, ratios_c = [], [], []
    bench_faithful_c(df, reps=5)  # build + warm the shared library
    for _ in range(5):
        o = bench_ours(df, reps=25)
        b = bench_baseline(df, reps=25)
        fc = bench_faithful_c(df, reps=25)
        ours_rates.append(o)
        ratios.append(o / b)
        ratios_c.append(o / fc)
    ours = float(np.median(ours_rates))
    # vs_baseline keeps its round-1..3 meaning (serial-numpy ratio) for
    # round-over-round trackers; vs_faithful_c is the compiled-C bar
    print(json.dumps({
        "metric": "config1_gaussian_fit_slogl_sample_pipelines_per_s",
        "value": round(ours, 2),
        "unit": "pipelines/s (4-node GBN, 1k rows)",
        "vs_baseline": round(float(np.median(ratios)), 2),
        "vs_faithful_c": round(float(np.median(ratios_c)), 2),
        "vs_serial_numpy": round(float(np.median(ratios)), 2),
    }))


if __name__ == "__main__":
    main()
