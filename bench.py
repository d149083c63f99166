"""Benchmark harness: CV-likelihood score throughput on a 10k-row
semiparametric network (BASELINE.json north star, config 3).

Measures how many (family, 10-fold CV) local-score evaluations per second the
framework sustains — the hot operation of KDE/semiparametric structure search
(SURVEY.md §3.1). The baseline is the same workload executed the reference's
way: one serial scipy fit + logpdf per (family, fold), which stands in for
the reference's single-device OpenCL pipeline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import time

import numpy as np

from chip_smoke import bench_families as families
from chip_smoke import bench_frame as make_data
from pybnesian_tpu.runtime.config import enable_compile_cache

enable_compile_cache()


def bench_ours(df, fams, k=10):
    from pybnesian_tpu.factors.ckde import CKDEType
    from pybnesian_tpu.learning.scores.likelihood import CVLikelihood
    from pybnesian_tpu.models import KDENetwork

    score = CVLikelihood(df, k=k, seed=0)
    model = KDENetwork(list(df))
    ckde = CKDEType()
    d = len(df)

    def run_once(shift):
        # the structure-search path: all candidate families in batched
        # device launches (Score.local_score_batch). The family set is
        # rotated per rep — same shapes (no recompile), different gather
        # indices — as hill-climbing re-scores changing candidate sets
        # against a fixed score instance.
        batch = [(v, ps, ckde) for v, ps in families(d, shift)]
        return float(score.local_score_batch(model, batch).sum())

    t0 = time.time()
    warm_total = run_once(1)  # includes compile
    warmup = time.time() - t0

    # valid shifts are 1..d-2 (shift+1 == d would make a family its own
    # parent); warm used 1, reps use the rest — every rep distinct
    reps = max(1, min(3, d - 3))
    t0 = time.time()
    for r in range(reps):
        run_once(2 + r)
    elapsed = (time.time() - t0) / reps
    return len(fams) / elapsed, warmup, warm_total


def bench_baseline_faithful(df, fams, k=10, max_fams=4):
    """Vectorized numpy implementation of the reference's EXACT kernel
    sequence (kde/KDE.hpp:592-640 + CKDE.hpp:202-254), per (family, fold):
    normal-reference bandwidth from the train covariance, Cholesky,
    triangular-solve whitening, pairwise subtract/square distances,
    logsumexp — joint and marginal — then the conditional subtraction. This
    is a much closer stand-in for the reference's OpenCL pipeline than
    scipy.gaussian_kde (same math, numpy's vectorized C loops standing in
    for the GPU kernels)."""
    from scipy.linalg import solve_triangular
    from scipy.special import logsumexp

    n = len(next(iter(df.values())))
    rng = np.random.default_rng(0)
    idx = rng.permutation(n)
    folds = np.array_split(idx, k)
    sub = fams[:max_fams]

    def kde_logl(train, test):
        nt, d = train.shape
        kfac = (4.0 / (nt * (d + 2.0))) ** (2.0 / (d + 4.0))
        H = kfac * np.cov(train, rowvar=False, ddof=1).reshape(d, d)
        L = np.linalg.cholesky(H)
        tw = solve_triangular(L, train.T, lower=True).T
        sw = solve_triangular(L, test.T, lower=True).T
        # pairwise d² via the matmul identity (one BLAS gemm) — the fastest
        # CPU form of the reference's subtract/square kernel sequence
        d2 = (
            np.sum(sw * sw, axis=1)[:, None]
            - 2.0 * (sw @ tw.T)
            + np.sum(tw * tw, axis=1)[None, :]
        )
        lognorm = (
            -np.sum(np.log(np.diag(L)))
            - 0.5 * d * np.log(2 * np.pi)
            - np.log(nt)
        )
        return logsumexp(-0.5 * d2, axis=1) + lognorm

    t0 = time.time()
    for v, ps in sub:
        cols = [v, *ps]
        mat = np.column_stack([df[c] for c in cols]).astype(np.float64)
        for f in range(k):
            test_idx = folds[f]
            train_idx = np.concatenate([folds[j] for j in range(k) if j != f])
            train = mat[train_idx]
            test = mat[test_idx]
            ll = kde_logl(train, test)
            if ps:
                ll = ll - kde_logl(train[:, 1:], test[:, 1:])
            float(ll.sum())
    elapsed = time.time() - t0
    return len(sub) / elapsed


def bench_baseline(df, fams, k=10, max_fams=4):
    """Reference-style serial loop: scipy gaussian_kde per (family, fold)."""
    from scipy.stats import gaussian_kde

    n = len(next(iter(df.values())))
    rng = np.random.default_rng(0)
    idx = rng.permutation(n)
    folds = np.array_split(idx, k)
    sub = fams[:max_fams]
    t0 = time.time()
    for v, ps in sub:
        cols = [v, *ps]
        mat = np.column_stack([df[c] for c in cols]).astype(np.float64)
        for f in range(k):
            test_idx = folds[f]
            train_idx = np.concatenate([folds[j] for j in range(k) if j != f])
            train = mat[train_idx]
            test = mat[test_idx]
            joint = gaussian_kde(train.T, bw_method="silverman")
            ll = joint.logpdf(test.T)
            if ps:
                marg = gaussian_kde(train[:, 1:].T, bw_method="silverman")
                ll = ll - marg.logpdf(test[:, 1:].T)
            float(ll.sum())
    elapsed = time.time() - t0
    return len(sub) / elapsed


def main():
    import jax

    from pybnesian_tpu.ops.kde import cv_pairs_route

    df = make_data()
    fams = families(len(df))

    ours_rate, warmup, total = bench_ours(df, fams)
    faithful_rate = bench_baseline_faithful(df, fams)
    scipy_rate = bench_baseline(df, fams)
    dev = jax.devices()[0]

    # vs_baseline is measured against the STRICTER (faster) of the two
    # serial stand-ins for the reference's OpenCL pipeline: a faithful
    # vectorized numpy port of its exact kernel sequence, and
    # scipy.gaussian_kde. Both raw ratios are reported.
    best_base = max(faithful_rate, scipy_rate)
    print(
        json.dumps(
            {
                "metric": "cvlik_ckde_family_scores_per_s_10k_rows",
                "value": round(ours_rate, 3),
                "unit": "family-scores/s (10-fold CV, 10k rows)",
                "vs_baseline": round(ours_rate / best_base, 2),
                "vs_faithful_numpy": round(ours_rate / faithful_rate, 2),
                "vs_scipy_kde": round(ours_rate / scipy_rate, 2),
                "kernel": cv_pairs_route(dev.platform, np.float32),
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
