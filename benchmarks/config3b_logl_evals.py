"""BASELINE metric: KDE+LG log-likelihood evals/s/chip.

Workload: a fitted 8-node semiparametric network (4 CKDE + 4 LinearGaussian
nodes, chain structure) evaluating model.slogl on a 10k-row test set — the
per-node factor logls counted as one "eval" each per row. The batched model
path issues ONE device launch for all CKDE nodes
(models/base.py _batched_ckde_logl); LG nodes are closed-form host math.

Baseline: the same computation the reference's way — one scipy
gaussian_kde.logpdf per CKDE node (joint + marginal) plus numpy normal
logpdfs for LG nodes, serial.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pybnesian_tpu.runtime.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

N_TRAIN = 10_000
N_TEST = 10_000
D = 8


def make_data(n, seed):
    import pandas as pd

    rng = np.random.default_rng(seed)
    cols = {}
    prev = rng.normal(0, 1, n)
    cols["x0"] = prev
    for i in range(1, D):
        prev = np.sin(0.8 * prev) + 0.5 * prev + rng.normal(0, 0.6, n)
        cols[f"x{i}"] = prev
    return pd.DataFrame({k: v.astype(np.float32) for k, v in cols.items()})


def main():
    from pybnesian_tpu import CKDEType, SemiparametricBN

    train = make_data(N_TRAIN, 0)
    test = make_data(N_TEST, 1)
    names = list(train.columns)
    arcs = [(names[i], names[i + 1]) for i in range(D - 1)]
    types = [(names[i], CKDEType()) for i in range(0, D, 2)]
    model = SemiparametricBN(names, arcs, types)
    model.fit(train)

    model.slogl(test)  # warm (compile)
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        model.slogl(test)
    ours = D * N_TEST / ((time.time() - t0) / reps)

    # reference-style serial scipy loop (subset of nodes, extrapolated)
    from scipy.stats import gaussian_kde
    from scipy.stats import norm

    tr64 = train.to_numpy().astype(np.float64)
    te64 = test.to_numpy().astype(np.float64)
    t0 = time.time()
    evals = 0
    for i in range(0, D, 2):  # the CKDE nodes dominate
        cols = [i] if i == 0 else [i, i - 1]
        joint = gaussian_kde(tr64[:, cols].T, bw_method="silverman")
        ll = joint.logpdf(te64[:, cols].T)
        if len(cols) > 1:
            marg = gaussian_kde(tr64[:, cols[1:]].T, bw_method="silverman")
            ll = ll - marg.logpdf(te64[:, cols[1:]].T)
        evals += N_TEST
        if time.time() - t0 > 60:
            break
    for i in range(1, D, 2):  # LG nodes: closed form, cheap
        beta, res = np.linalg.lstsq(
            np.column_stack([np.ones(N_TRAIN), tr64[:, i - 1]]),
            tr64[:, i], rcond=None,
        )[:2]
        sigma2 = res[0] / (N_TRAIN - 2)
        mu = beta[0] + beta[1] * te64[:, i - 1]
        norm.logpdf(te64[:, i], mu, np.sqrt(sigma2))
        evals += N_TEST
    base = evals / (time.time() - t0)

    print(json.dumps({
        "metric": "config3b_kde_lg_logl_evals_per_s_per_chip",
        "value": round(ours, 1),
        "unit": f"factor-row log-lik evals/s ({D}-node SPBN, {N_TEST} rows)",
        "vs_baseline": round(ours / base, 2),
    }))


if __name__ == "__main__":
    main()
