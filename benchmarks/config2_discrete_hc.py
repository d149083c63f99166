"""BASELINE config 2: discrete BN hill-climbing with BDe/BIC, 20 nodes,
10k rows — exercises the batched count/score kernels
(ops/discrete.py scatter-count path vs the reference's per-family stride
counting, learning/parameters/mle_DiscreteFactor.cpp).

Metric: local-score (family) evaluations per second inside a full hc run,
vs a serial numpy contingency-count baseline.

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

N_NODES = 20
N_ROWS = 10_000


def make_data(n=N_ROWS, d=N_NODES, seed=0):
    import pandas as pd

    rng = np.random.default_rng(seed)
    cols = {}
    prev = rng.integers(0, 3, n)
    for i in range(d):
        flip = rng.random(n) < 0.3
        cur = np.where(flip, rng.integers(0, 3, n), prev)
        cols[f"v{i}"] = pd.Categorical.from_codes(cur, ["x", "y", "z"])
        prev = cur
    return pd.DataFrame(cols)


def bench_ours(df):
    from pybnesian_tpu import DiscreteBN, BIC, ArcOperatorSet
    from pybnesian_tpu.learning.algorithms import GreedyHillClimbing

    score = BIC(df)
    model = DiscreteBN(list(df.columns))
    # warm-up run populates the XLA compile cache for every batch shape hc
    # hits; the measured run is steady-state throughput (first compiles
    # take seconds per shape)
    GreedyHillClimbing().estimate(ArcOperatorSet(), score, model, max_iters=15)
    t0 = time.time()
    learned = GreedyHillClimbing().estimate(
        ArcOperatorSet(), score, model, max_iters=15
    )
    elapsed = time.time() - t0
    # hc evaluates ~n^2 families at cache time + ~2n per iteration
    n = len(df.columns)
    iters = min(15, learned.num_arcs() + 1)
    fam_evals = n * (n - 1) + iters * 2 * n
    return fam_evals / elapsed, learned.num_arcs()


def bench_baseline(df, n_fams=40):
    """Serial numpy BIC for discrete families: crosstab counts + log-ratio."""
    codes = {c: df[c].cat.codes.to_numpy() for c in df.columns}
    names = list(df.columns)
    n = len(df)
    t0 = time.time()
    k = 0
    for i in range(len(names)):
        for j in range(len(names)):
            if i == j:
                continue
            v, p = codes[names[i]], codes[names[j]]
            joint = np.zeros((3, 3))
            np.add.at(joint, (v, p), 1.0)
            marg = joint.sum(axis=0, keepdims=True)
            with np.errstate(divide="ignore", invalid="ignore"):
                ll = np.nansum(joint * (np.log(joint) - np.log(marg)))
            ll - 0.5 * np.log(n) * 6.0
            k += 1
            if k >= n_fams:
                return k / (time.time() - t0)
    return k / (time.time() - t0)


def bench_faithful_c(df, n_fams=400):
    """Compiled serial stand-in for the reference's stride counting + BIC
    (benchmarks/faithful_c/faithful.cpp, mirrors mle_DiscreteFactor.cpp)."""
    from faithful_c import discrete_bic_rate

    return discrete_bic_rate(df, n_fams)


def main():
    df = make_data()
    ours, num_arcs = bench_ours(df)
    base = bench_baseline(df)
    base_c = bench_faithful_c(df)
    # vs_baseline keeps its round-1..3 meaning (serial-numpy ratio) for
    # round-over-round trackers; vs_faithful_c is the compiled-C bar
    print(json.dumps({
        "metric": "config2_discrete_hc_family_scores_per_s",
        "value": round(ours, 1),
        "unit": f"family-scores/s (20-node DiscreteBN hc, 10k rows, learned {num_arcs} arcs)",
        "vs_baseline": round(ours / base, 2),
        "vs_faithful_c": round(ours / base_c, 2),
        "vs_serial_numpy": round(ours / base, 2),
    }))


if __name__ == "__main__":
    main()
