"""Micro-benchmark: UCV bandwidth selection — whole Nelder-Mead on device
in ONE dispatch (ops/nelder_mead.py + kde/ucv.py) vs a serial numpy UCV
(the reference runs NLopt Nelder-Mead with one O(n²) device score per
simplex step, kde/UCV.cpp:469-505).

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

N, D = 4000, 2


def make_data(seed=0):
    import pandas as pd

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, N)
    y = 0.6 * x + rng.normal(0, 0.8, N)
    return pd.DataFrame({"x": x, "y": y})


def numpy_ucv_score(data, h_chol):
    """Brute-force UCV objective: (reference UCV.hpp:12-47 pair triangle)."""
    from scipy.linalg import solve_triangular

    n, d = data.shape
    w = solve_triangular(h_chol, data.T, lower=True).T
    d2 = (
        np.sum(w * w, 1)[:, None]
        - 2.0 * (w @ w.T)
        + np.sum(w * w, 1)[None, :]
    )
    iu = np.triu_indices(n, 1)
    pd2 = d2[iu]
    logdet = np.sum(np.log(np.diag(h_chol)))
    c = (2 * np.pi) ** (-d / 2.0)
    k2h = c * np.exp(-0.25 * pd2) * 2.0 ** (-d / 2.0)
    kh = c * np.exp(-0.5 * pd2)
    s = np.sum(k2h - 2.0 * n / (n - 1.0) * kh)
    return float(
        np.exp(-logdet)
        * ((2.0 ** (-d / 2.0)) * c / n + 2.0 * s / (n * (n - 1.0)))
    )


def bench_baseline(df, iters=600):
    """Serial numpy Nelder-Mead over vech(chol(H)) with the brute pair
    triangle per evaluation — the reference's structure (NLopt Nelder-Mead,
    kde/UCV.cpp:469-505). Full minimization, same iteration cap as the
    device path (200 x len(x0))."""
    from scipy.optimize import minimize

    data = df.to_numpy().astype(np.float64)
    n, d = data.shape
    kfac = (4.0 / (n * (d + 2.0))) ** (2.0 / (d + 4.0))
    h0 = kfac * np.cov(data, rowvar=False)
    l0 = np.linalg.cholesky(h0)
    x0 = l0[np.tril_indices(d)]
    evals = [0]

    def obj(x):
        evals[0] += 1
        L = np.zeros((d, d))
        L[np.tril_indices(d)] = x
        if np.any(np.diag(L) <= 0):
            return 1e100
        return numpy_ucv_score(data, L)

    t0 = time.time()
    minimize(obj, x0, method="Nelder-Mead", options={"maxiter": iters})
    return 1.0 / (time.time() - t0)


def bench_ours(df):
    from pybnesian_tpu import UCV

    ucv = UCV()
    h = ucv.bandwidth(df, ["x", "y"])  # warm (compiles)
    t0 = time.time()
    reps = 3
    for r in range(reps):
        # vary data slightly so no cache serves repeats
        h = ucv.bandwidth(df + (r + 1) * 1e-6, ["x", "y"])
    elapsed = (time.time() - t0) / reps
    assert np.all(np.isfinite(h))
    return 1.0 / elapsed


def main():
    df = make_data()
    ours = bench_ours(df)
    base = bench_baseline(df)
    print(json.dumps({
        "metric": "micro_ucv_bandwidth_selections_per_s_4k_rows",
        "value": round(ours, 1),
        "unit": "full-H UCV bandwidth selections/s (4k rows, d=2)",
        "vs_baseline": round(ours / base, 2),
    }))


if __name__ == "__main__":
    main()
