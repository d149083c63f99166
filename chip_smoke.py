#!/usr/bin/env python3
"""Smoke run of pybnesian_tpu's main path on a GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the mesh phase only

Drives the public API at the data sizes users run, on random data made
from ``--seed``, and checks every result against a plain float64
numpy/scipy reference:

1. ``ckde_cv``   CVLikelihood(k=10).local_score_batch, 10k rows × 5
                 variables, 15 CKDE families (the north-star path), and
                 the streaming Pallas kernel against the XLA kernel;
2. ``hc_spbn``   hc(SemiparametricBNType, CVLikelihood), 10k rows × 8;
   ``hc_bic``    hc(GaussianNetworkType, BIC), 10⁵ rows × 20, on the device
                 BIC path;
3. ``slogl``     fit + slogl of the learned semiparametric model;
4. ``rcot``      RCoT.pvalue_batch, 64 tests at 20k rows;
   ``pc``        PC().estimate(LinearCorrelation), 10⁵ rows;
5. ``nuts``      make_logdensity + sample_chains, 4 chains of NUTS.

Prints the card's name and power limit first, one JSON line per phase, and
as the last line ``{"ok": true, "device": {...}}`` only when every phase
passed. Exits non-zero, printing no such line, when JAX finds no GPU or any
phase fails. Everything runs in this one process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
import traceback
from functools import partial

import numpy as np

LOG_2PI = math.log(2.0 * math.pi)


# --------------------------------------------------------------------- data
def bench_frame(n=10_000, d=5, seed=0, dtype=np.float32):
    """The north-star frame: a chain with a sine link between columns."""
    rng = np.random.default_rng(seed)
    cols = {}
    base = rng.normal(0, 1, n)
    for i in range(d):
        noise = rng.normal(0, 0.6, n)
        if i == 0:
            cols[f"x{i}"] = base + noise
        else:
            prev = cols[f"x{i-1}"]
            cols[f"x{i}"] = np.sin(0.8 * prev) + 0.5 * prev + noise
    return {k: v.astype(dtype) for k, v in cols.items()}


def bench_families(d, shift=1):
    """For every variable: no parent, one parent, two parents."""
    names = [f"x{i}" for i in range(d)]
    fams = []
    for i, v in enumerate(names):
        fams.append((v, []))
        fams.append((v, [names[(i + shift) % d]]))
        fams.append((v, [names[(i + shift) % d], names[(i + shift + 1) % d]]))
    return fams


def linear_frame(n, d, seed=0, dtype=np.float32, loc=0.0):
    """Linear-Gaussian chain: x_i = 0.8·x_{i−1} − 0.5·x_{i−2} + noise,
    then column i moved to mean ``loc``·(i mod 4)."""
    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(d):
        x = rng.normal(0, 1.0, n)
        if i >= 1:
            x += 0.8 * cols[f"x{i-1}"]
        if i >= 2:
            x -= 0.5 * cols[f"x{i-2}"]
        cols[f"x{i}"] = x
    return {k: (v + loc * (i % 4)).astype(dtype)
            for i, (k, v) in enumerate(cols.items())}


def config3_kernel_args(score, fams):
    """The fused CV-CKDE kernels' arguments for ``fams`` (at most 16) on a
    CVLikelihood's own device arrays: the north-star batch, padded to 16
    families of up to 4 columns (evidence first, variable last)."""
    import jax.numpy as jnp

    pos, data, null_mask, tr_idx, tr_mask, te_idx, te_mask, _ = (
        score._engine._device_cv_cache(256)
    )
    col_idx = np.zeros((16, 4), np.int32)
    col_mask = np.zeros((16, 4), np.float32)
    for f, (v, ps) in enumerate(fams):
        for j, c in enumerate([*ps, v]):
            col_idx[f, j] = pos[c]
            col_mask[f, j] = 1.0
    col_mask[len(fams):, 0] = 1.0
    return (data, null_mask, jnp.asarray(col_idx), jnp.asarray(col_mask),
            tr_idx, tr_mask, te_idx, te_mask)


def _matrix(frame, cols):
    return np.column_stack([np.asarray(frame[c], np.float64) for c in cols])


# ------------------------------------------------------------------ oracles
def _logsumexp_rows(a):
    m = a.max(axis=1, keepdims=True)
    return (m + np.log(np.exp(a - m).sum(axis=1, keepdims=True)))[:, 0]


def kde_logl_oracle(train, test, H=None, chunk=1024):
    """Per-test-row Gaussian KDE log-density in float64 with the
    normal-reference bandwidth of ``train`` (reference kde/KDE.hpp)."""
    from scipy.linalg import solve_triangular

    nt, d = train.shape
    if H is None:
        k = (4.0 / (nt * (d + 2.0))) ** (2.0 / (d + 4.0))
        H = k * np.cov(train, rowvar=False, ddof=1).reshape(d, d)
    L = np.linalg.cholesky(H)
    tw = solve_triangular(L, train.T, lower=True).T
    sw = solve_triangular(L, test.T, lower=True).T
    lognorm = (-np.sum(np.log(np.diag(L))) - 0.5 * d * LOG_2PI
               - math.log(nt))
    out = np.empty(len(sw))
    for s in range(0, len(sw), chunk):
        blk = sw[s:s + chunk]
        d2 = ((blk[:, None, :] - tw[None, :, :]) ** 2).sum(-1)
        out[s:s + chunk] = _logsumexp_rows(-0.5 * d2)
    return out + lognorm, H


def ckde_cv_oracle(mat, folds):
    """Summed k-fold CV log-likelihood of a CKDE family; column 0 is the
    variable, the rest its parents. The kernel sequence of bench.py
    bench_baseline_faithful, except that the marginal takes the joint
    bandwidth's parent block, as the reference CKDE does (CKDE.hpp:182-200)
    and bench.py's timing baseline does not."""
    total = 0.0
    for tr, te in folds:
        train, test = mat[tr], mat[te]
        lj, H = kde_logl_oracle(train, test)
        if mat.shape[1] > 1:
            lm, _ = kde_logl_oracle(train[:, 1:], test[:, 1:], H=H[1:, 1:])
            lj = lj - lm
        total += float(lj.sum())
    return total


def _ols(y, X):
    A = np.column_stack([np.ones(len(y)), X])
    beta = np.linalg.lstsq(A, y, rcond=None)[0]
    rss = float(np.sum((y - A @ beta) ** 2))
    return beta, rss


def lg_cv_oracle(y, X, folds):
    """Summed k-fold CV log-likelihood of a linear-Gaussian family."""
    total = 0.0
    for tr, te in folds:
        beta, rss = _ols(y[tr], X[tr])
        var = rss / (len(tr) - X.shape[1] - 1)
        mean = beta[0] + X[te] @ beta[1:]
        total += float(np.sum(-0.5 * (y[te] - mean) ** 2 / var
                              - 0.5 * math.log(var) - 0.5 * LOG_2PI))
    return total


def bic_oracle(y, X):
    """Gaussian BIC local score (reference learning/scores/bic.cpp)."""
    n, k = len(y), X.shape[1]
    _, rss = _ols(y, X)
    var = rss / (n - k - 1)
    loglik = 0.5 * (1 + k - n) - 0.5 * n * LOG_2PI - 0.5 * n * math.log(var)
    return loglik - 0.5 * math.log(n) * (k + 2)


def lg_batch_oracle(values, var_idx, parent_idx, parent_mask):
    """Float64 least squares of every family of a padded LG batch: betas
    (F, P+1) with 0 for masked parents, variances (F,) and BIC (F,)."""
    values = np.asarray(values, np.float64)
    F, P = parent_idx.shape
    betas = np.zeros((F, P + 1))
    variances = np.zeros(F)
    bics = np.zeros(F)
    for f in range(F):
        on = np.flatnonzero(parent_mask[f])
        y, X = values[:, var_idx[f]], values[:, parent_idx[f, on]]
        beta, rss = _ols(y, X)
        betas[f, 0] = beta[0]
        betas[f, 1 + on] = beta[1:]
        variances[f] = rss / (len(y) - len(on) - 1)
        bics[f] = bic_oracle(y, X)
    return betas, variances, bics


#: The bound on a float32 variance's error relative to float64 least
#: squares. It moves a BIC score by 0.5·n·VAR_RTOL units: 1 unit at 10^6
#: rows, a seventh of the penalty 0.5·ln(10^6) ≈ 6.9 that one parameter
#: costs there, so a score error cannot flip a comparison that one
#: parameter decides.
VAR_RTOL = 2e-6


def bic_atol(n):
    """:data:`VAR_RTOL` in BIC units at ``n`` rows."""
    return 0.5 * n * VAR_RTOL


def _diffs(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ad = np.abs(got - want)
    rd = ad / np.maximum(np.abs(want), 1e-300)
    return float(ad.max()), float(rd.max())


def _check(name, max_abs, max_rel, rtol=None, atol=None):
    bad = (rtol is not None and not max_rel <= rtol) or (
        atol is not None and not max_abs <= atol
    )
    if bad:
        raise AssertionError(
            f"{name}: max abs diff {max_abs:.3e}, max rel diff "
            f"{max_rel:.3e} outside rtol={rtol} atol={atol}"
        )


# ------------------------------------------------------------------- phases
# Each phase returns (work, check): ``work()`` is the device workload
# through the public API (timed twice: first call with compilation, then
# steady), ``check(result)`` compares it with the reference and returns the
# fields of the phase's report line.
def phase_ckde_cv(n=10_000, d=5, k=10, seed=0, compare=(0, 1, 2, 4)):
    import jax

    from pybnesian_tpu import CKDEType, CVLikelihood, KDENetwork
    from pybnesian_tpu.ops.kde import (
        ckde_cv_alldevice,
        ckde_cv_alldevice_flash,
        cv_pairs_route,
    )

    frame = bench_frame(n, d, seed)
    fams = bench_families(d)
    score = CVLikelihood(frame, k=k, seed=seed)
    model = KDENetwork(list(frame))
    batch = [(v, ps, CKDEType()) for v, ps in fams]

    def work():
        return score.local_score_batch(model, batch)

    def check(out):
        folds = [score.cv_folds().fold_indices(i) for i in range(k)]
        got, want = [], []
        for i in compare:
            v, ps = fams[i]
            got.append(out[i])
            want.append(ckde_cv_oracle(_matrix(frame, [v, *ps]), folds))
        max_abs, max_rel = _diffs(got, want)
        rtol = 1e-4
        _check("CV score vs float64 oracle", max_abs, max_rel, rtol=rtol)
        if not np.all(np.isfinite(out)):
            raise AssertionError(f"non-finite CV scores: {out}")
        # the kernel this platform runs, against the XLA kernel, on one
        # padded 16-family batch of the scoring path's own device arrays
        args = config3_kernel_args(score, fams)
        route = cv_pairs_route(jax.default_backend(), args[0].dtype)
        xla = np.asarray(ckde_cv_alldevice(*args, chunk=256), np.float64)
        kernel = {}
        if route == "triton":
            flash = np.asarray(ckde_cv_alldevice_flash(*args), np.float64)
            kabs, krel = _diffs(flash, xla)
            _check("Pallas kernel vs XLA kernel", kabs, krel, rtol=rtol)
            kernel = {"kernel_vs_xla_max_abs": kabs,
                      "kernel_vs_xla_max_rel": krel}
        return {
            "max_abs_diff": max_abs, "max_rel_diff": max_rel,
            "tolerance": {"rtol": rtol, "reason": (
                "float32 bandwidth, whitening and exp against a float64 "
                "oracle; summed over ~n test rows per family")},
            "families_compared": [fams[i] for i in compare],
            "route": route, **kernel,
        }

    return work, check


def phase_hc_spbn(n=10_000, d=8, k=10, max_iters=3, seed=0, keep=None):
    """``keep`` (a dict) receives the learned model and its frame."""
    from pybnesian_tpu import (
        CVLikelihood,
        LinearGaussianCPDType,
        SemiparametricBNType,
        hc,
    )

    frame = bench_frame(n, d, seed)
    state = {}

    def work():
        score = CVLikelihood(frame, k=k, seed=seed)
        model = hc(frame, bn_type=SemiparametricBNType(), score=score,
                   max_iters=max_iters, seed=seed)
        state.update(score=score)
        if keep is not None:
            keep.update(model=model, frame=frame)
        return model

    def check(model):
        score = state["score"]
        if model.num_arcs() == 0:
            raise AssertionError("hc learned no arc on dependent data")
        types = {n_: model.node_type(n_).ToString() for n_ in model.nodes()}
        # the CV-LG kernel against a float64 least-squares oracle
        folds = [score.cv_folds().fold_indices(i) for i in range(k)]
        lg = LinearGaussianCPDType()
        fams = [("x1", ["x0"]), ("x3", ["x2", "x4"]), ("x5", []),
                ("x7", ["x6", "x0", "x2"])]
        got = score.local_score_batch(model, [(v, ps, lg) for v, ps in fams])
        want = [lg_cv_oracle(_matrix(frame, [v])[:, 0], _matrix(frame, ps)
                             if ps else np.zeros((n, 0)), folds)
                for v, ps in fams]
        max_abs, max_rel = _diffs(got, want)
        rtol = 1e-5
        _check("CV-LG score vs float64 oracle", max_abs, max_rel, rtol=rtol)
        return {
            "max_abs_diff": max_abs, "max_rel_diff": max_rel,
            "tolerance": {"rtol": rtol, "reason": (
                "float32 Gram at HIGHEST over ~n rows per fold against "
                "float64 least squares")},
            "arcs": sorted(model.arcs()), "node_types": types,
        }

    return work, check


@contextlib.contextmanager
def gram_precision(precision):
    """Run the Gaussian kernels (ops/gaussian.py) at another matmul
    precision than HIGHEST: the control that shows what the check of
    phase ``hc_bic`` would read if the Grams ran at DEFAULT (TF32 on a
    GPU)."""
    import jax

    from pybnesian_tpu.ops import gaussian

    saved = gaussian.HIGHEST
    gaussian.HIGHEST = precision
    jax.clear_caches()
    try:
        yield
    finally:
        gaussian.HIGHEST = saved
        jax.clear_caches()


def phase_hc_bic(n=100_000, d=20, max_iters=10, seed=0):
    import jax
    import jax.numpy as jnp

    from pybnesian_tpu import BIC, GaussianNetworkType, hc
    from pybnesian_tpu.learning.scores import bic as bic_mod

    frame = linear_frame(n, d, seed, loc=3.0)
    calls = {"device": 0}
    inner = bic_mod._padded_batched_bic

    def counted(*a, **kw):
        calls["device"] += 1
        return inner(*a, **kw)

    def work():
        bic_mod._padded_batched_bic = counted
        try:
            model = hc(frame, bn_type=GaussianNetworkType(), score=BIC(frame),
                       max_iters=max_iters, seed=seed)
        finally:
            bic_mod._padded_batched_bic = inner
        return model

    def check(model):
        if calls["device"] == 0:
            raise AssertionError("BIC scoring never took the device path")
        if model.num_arcs() == 0:
            raise AssertionError("hc learned no arc on dependent data")
        names = list(frame)
        fams = [(v, model.parents(v)) for v in names[:8]]
        fams += [(names[i], [names[i - 1], names[i - 2]])
                 for i in range(2, 10)]
        pos = {c: i for i, c in enumerate(names)}
        idx = [(pos[v], [pos[p] for p in ps]) for v, ps in fams]
        values = jnp.asarray(np.column_stack([frame[c] for c in names]))
        valid = jnp.ones_like(values)
        want = [bic_oracle(_matrix(frame, [v])[:, 0],
                           _matrix(frame, ps) if ps else np.zeros((n, 0)))
                for v, ps in fams]
        got = inner(values, valid, idx)
        max_abs, max_rel = _diffs(got, want)
        with gram_precision(jax.lax.Precision.DEFAULT):
            ctl_abs, ctl_rel = _diffs(inner(values, valid, idx), want)
        atol = bic_atol(n)
        _check("BIC vs float64 least squares", max_abs, max_rel, atol=atol)
        return {
            "max_abs_diff": max_abs, "max_rel_diff": max_rel,
            "tolerance": {"atol": atol, "reason": (
                "BIC units: a variance error of 2e-6 relative; data with "
                "column means 0-9")},
            "control_default_precision": {
                "max_abs_diff": ctl_abs, "max_rel_diff": ctl_rel,
                "within_bound": ctl_abs <= atol},
            "device_bic_calls": calls["device"], "arcs": model.num_arcs(),
        }

    return work, check


def phase_slogl(model, frame):
    """Fit the learned semiparametric model (at least two CKDE nodes) and
    take its slogl on the training rows."""
    from pybnesian_tpu import CKDEType

    model = model.clone()
    ckde = [v for v in model.nodes()
            if model.node_type(v).ToString() == CKDEType().ToString()]
    for v in model.nodes():
        if len(ckde) >= 2:
            break
        if v not in ckde:
            model.set_node_type(v, CKDEType())
            ckde.append(v)

    def work():
        model.fit(frame)
        return model.slogl(frame)

    def check(total):
        n = len(next(iter(frame.values())))
        want = 0.0
        for v in model.nodes():
            ps = model.parents(v)
            y = _matrix(frame, [v])[:, 0]
            X = _matrix(frame, ps) if ps else np.zeros((n, 0))
            if v in ckde:
                joint = np.column_stack([y, X])
                lj, H = kde_logl_oracle(joint, joint)
                if ps:
                    lm, _ = kde_logl_oracle(X, X, H=H[1:, 1:])
                    lj = lj - lm
                want += float(lj.sum())
            else:
                beta, rss = _ols(y, X)
                var = rss / (n - X.shape[1] - 1)
                mean = beta[0] + X @ beta[1:]
                want += float(np.sum(-0.5 * (y - mean) ** 2 / var
                                     - 0.5 * math.log(var) - 0.5 * LOG_2PI))
        max_abs, max_rel = _diffs([total], [want])
        rtol = 1e-4
        _check("slogl vs float64 oracle", max_abs, max_rel, rtol=rtol)
        return {
            "max_abs_diff": max_abs, "max_rel_diff": max_rel,
            "tolerance": {"rtol": rtol, "reason": (
                "float32 KDE and LG log-densities summed over n rows "
                "against float64 per-CPD oracles")},
            "ckde_nodes": ckde,
        }

    return work, check


def phase_rcot(n=20_000, d=8, n_tests=64, n_parity=4, seed=0):
    import jax.numpy as jnp

    from pybnesian_tpu import RCoT
    from pybnesian_tpu.learning.independences.rcot import (
        _get_batched,
        _pvalue_from_eigs,
        _rff_kernel,
        _test_with_z_core,
        rf_sigma,
    )

    frame = bench_frame(n, d, seed)
    names = list(frame)
    triples = []
    for i in range(d):
        for j in range(i + 1, d):
            rest = [c for c in names if c not in (names[i], names[j])]
            triples.append((names[i], names[j], []))
            triples.append((names[i], names[j], rest[:1]))
            triples.append((names[i], names[j], rest[1:3]))
    triples = triples[:n_tests]
    test = RCoT(frame, seed=seed)

    def work():
        return test.pvalue_batch(triples)

    def shared_draw(x, y, z, rng):
        # serial route (host float64 solve) and batch route (device float32
        # Cholesky) on the SAME random Fourier draw
        num_xy, num_z = 5, 100
        Wx = rng.standard_normal((1, num_xy)) / rf_sigma(x)
        bx = rng.uniform(0, 2 * np.pi, num_xy)
        Wy = rng.standard_normal((1, num_xy)) / rf_sigma(y)
        by = rng.uniform(0, 2 * np.pi, num_xy)
        Wz = rng.standard_normal((z.shape[1], num_z)) / rf_sigma(z)
        bz = rng.uniform(0, 2 * np.pi, num_z)
        f32 = jnp.float32
        rff = _rff_kernel()
        fx = rff(jnp.asarray(x[:, None], f32), jnp.asarray(Wx, f32),
                 jnp.asarray(bx, f32))
        fy = rff(jnp.asarray(y[:, None], f32), jnp.asarray(Wy, f32),
                 jnp.asarray(by, f32))
        fz = rff(jnp.asarray(z, f32), jnp.asarray(Wz, f32),
                 jnp.asarray(bz, f32))
        sta_s, eigs_s = _test_with_z_core(fx, fy, fz)
        p_serial = _pvalue_from_eigs(np.asarray(eigs_s, np.float64), sta_s)
        fused_z, _ = _get_batched()
        data = jnp.asarray(np.column_stack([x, y, z]).astype(np.float32))
        sta_b, eigs_b = fused_z(
            data, jnp.asarray([0], jnp.int32), jnp.asarray(Wx[None, 0], f32),
            jnp.asarray(bx[None, :], f32), jnp.asarray([1], jnp.int32),
            jnp.asarray(Wy[None, 0], f32), jnp.asarray(by[None, :], f32),
            jnp.asarray(np.arange(2, 2 + z.shape[1], dtype=np.int32)[None]),
            jnp.ones((1, z.shape[1]), f32), jnp.asarray(Wz[None], f32),
            jnp.asarray(bz[None, :], f32),
        )
        p_batch = _pvalue_from_eigs(np.asarray(eigs_b, np.float64)[0],
                                    float(sta_b[0]))
        return p_serial, p_batch

    def check(pv):
        pv = np.asarray(pv)
        if pv.shape != (len(triples),) or not np.all(
            np.isfinite(pv) & (pv >= 0) & (pv <= 1)
        ):
            raise AssertionError(f"p-values out of [0, 1]: {pv}")
        rng = np.random.default_rng(seed + 1)
        cond = [t for t in triples if t[2]][:n_parity]
        got, want = [], []
        for x, y, zs in cond:
            ps, pb = shared_draw(_matrix(frame, [x])[:, 0],
                                 _matrix(frame, [y])[:, 0],
                                 _matrix(frame, zs), rng)
            got.append(pb)
            want.append(ps)
        max_abs, max_rel = _diffs(got, want)
        atol = 0.02
        _check("RCoT batch vs serial p-value", max_abs, max_rel, atol=atol)
        return {
            "max_abs_diff": max_abs, "max_rel_diff": max_rel,
            "tolerance": {"atol": atol, "reason": (
                "same feature draw: float32 jittered Cholesky (batch) vs "
                "float64 LU (serial) solve, as in "
                "tests/learning/test_rcot_solve_parity.py")},
            "tests": len(triples),
        }

    return work, check


def phase_pc(n=100_000, d=10, seed=0):
    from scipy.special import stdtr

    from pybnesian_tpu import PC, LinearCorrelation

    rng = np.random.default_rng(seed)
    frame = {}
    prev = None
    for i in range(d):
        x = rng.normal(0, 1, n) + (0.9 * prev if prev is not None else 0.0)
        frame[f"x{i}"] = x
        prev = x
    names = list(frame)
    truth = {frozenset((names[i], names[i + 1])) for i in range(d - 1)}

    def work():
        # alpha 1e-3: at 0.05 each of the ~40 absent edges still survives
        # with probability 0.05, whatever the row count
        test = LinearCorrelation(frame)
        return test, PC().estimate(test, alpha=1e-3)

    def check(out):
        test, graph = out
        edges = {frozenset(e) for e in graph.edges()} | {
            frozenset(a) for a in graph.arcs()
        }
        if edges != truth:
            raise AssertionError(f"PC skeleton {sorted(map(sorted, edges))}"
                                 " is not the generating chain")
        # conditional independences of the chain against a float64
        # partial-correlation oracle
        triples = [(names[0], names[2], [names[1]]),
                   (names[d - 4], names[d - 1], [names[d - 3], names[d - 2]]),
                   (names[1], names[4], [names[3]])]
        got = test.pvalue_batch(triples)
        want = []
        for x, y, zs in triples:
            A = np.column_stack([np.ones(n), _matrix(frame, zs)])
            rx = frame[x] - A @ np.linalg.lstsq(A, frame[x], rcond=None)[0]
            ry = frame[y] - A @ np.linalg.lstsq(A, frame[y], rcond=None)[0]
            r = float(rx @ ry / math.sqrt((rx @ rx) * (ry @ ry)))
            dof = n - 2 - len(zs)
            t = r * math.sqrt(dof / (1 - r * r))
            want.append(2 * stdtr(dof, -abs(t)))
        max_abs, max_rel = _diffs(got, want)
        atol = 1e-6
        _check("partial-correlation p-values", max_abs, max_rel, atol=atol)
        return {
            "max_abs_diff": max_abs, "max_rel_diff": max_rel,
            "tolerance": {"atol": atol, "reason": (
                "float64 on both sides; only summation order differs")},
            "edges": len(edges),
        }

    return work, check


def phase_nuts(n=10_000, d=4, num_samples=300, num_warmup=300, seed=0):
    import jax

    from pybnesian_tpu import GaussianNetwork
    from pybnesian_tpu.inference import make_logdensity, sample_chains

    frame = linear_frame(n, d, seed)
    names = list(frame)
    arcs = [(names[i - 1], names[i]) for i in range(1, d)]
    arcs += [(names[i - 2], names[i]) for i in range(2, d)]
    model = GaussianNetwork(names, arcs)
    model.fit(frame)
    logp, layout, init = make_logdensity(model, frame)

    def work():
        samples, info = sample_chains(
            logp, init, jax.random.PRNGKey(seed), num_chains=4,
            method="nuts", num_samples=num_samples, num_warmup=num_warmup,
        )
        return np.asarray(samples), info

    def check(out):
        samples, _ = out
        if samples.shape[:2] != (4, num_samples) or not np.all(
            np.isfinite(samples)
        ):
            raise AssertionError(f"bad samples, shape {samples.shape}")
        post = samples.reshape(-1, samples.shape[-1]).mean(axis=0)
        got, want = [], []
        for v in names:
            lo, hi, kind = layout.slices[v]
            ps = model.parents(v)
            X = _matrix(frame, ps) if ps else np.zeros((n, 0))
            beta, rss = _ols(_matrix(frame, [v])[:, 0], X)
            got.extend(post[lo:hi])
            want.extend([*beta, math.log(rss / n)])
        max_abs, max_rel = _diffs(got, want)
        atol = 0.05
        _check("posterior mean vs MLE", max_abs, max_rel, atol=atol)
        return {
            "max_abs_diff": max_abs, "max_rel_diff": max_rel,
            "tolerance": {"atol": atol, "reason": (
                "posterior sd of each coefficient and log-variance is "
                "~0.01-0.015 at 1e4 rows; the bound is ~4 sd")},
            "samples": list(samples.shape),
        }

    return work, check


# --------------------------------------------------------------- four cards
def phase_mesh(mesh, n_ckde=10_000, n_rows=1_000_000, d=20, n_train=65_536,
               num_samples=200, seed=0):
    """Every mesh kernel against its one-card form, on a (data, fam) mesh."""
    import jax
    import jax.numpy as jnp

    from pybnesian_tpu import CVLikelihood
    from pybnesian_tpu.inference import sample_chains, sample_chains_sharded
    from pybnesian_tpu.ops.gaussian import (
        batched_bic,
        batched_lg_params,
        family_grams,
    )
    from pybnesian_tpu.ops.kde import ckde_cv_alldevice
    from pybnesian_tpu.parallel import (
        _lse_all_gather,
        _lse_pmax_psum,
        _sharded_kde_slogl,
        sharded_batched_bic,
        sharded_ckde_cv,
        sharded_kde_slogl,
        sharded_lg_fit,
    )

    one = jax.devices()[0]
    rng = np.random.default_rng(seed)
    out = {}

    # CV-CKDE scoring, families sharded over 'fam'
    frame = bench_frame(n_ckde, 5, seed)
    args = config3_kernel_args(CVLikelihood(frame, k=10, seed=seed),
                               bench_families(5))
    ckde_cv = jax.jit(partial(sharded_ckde_cv, mesh))
    out["sharded_ckde_cv"] = (
        lambda: np.asarray(ckde_cv(*args)),
        lambda: np.asarray(ckde_cv_alldevice(*jax.device_put(args, one))),
        _close(1e-5, "same float32 kernel per family on one card"),
    )

    # LG fit and BIC, rows sharded over 'data', families over 'fam', at
    # 10^6 rows with column means 0-9; one card and the mesh each against
    # float64 least squares
    lg_frame = linear_frame(n_rows, d, seed, loc=3.0)
    values = np.column_stack(list(lg_frame.values()))
    valid = np.ones((n_rows, d), np.float32)
    F, P = 32, 3
    var_idx = (np.arange(F) % d).astype(np.int32)
    parent_idx = np.stack([(var_idx + s) % d for s in (1, 2, 3)], 1).astype(
        np.int32)
    parent_mask = np.ones((F, P), np.float32)
    parent_mask[::3, 2] = 0.0
    lg = tuple(jnp.asarray(a) for a in
               (values, valid, var_idx, parent_idx, parent_mask))
    lg1 = jax.device_put(lg, one)
    oracle = {}

    def want():
        if not oracle:
            oracle["v"] = lg_batch_oracle(values, var_idx, parent_idx,
                                          parent_mask)
        return oracle["v"]

    def fit_one():
        grams, n_eff = family_grams(*lg1)
        betas, variances, _ = batched_lg_params(grams, lg1[4], n_eff)
        return np.concatenate([np.asarray(betas), np.asarray(variances)[:, None]],
                              axis=1)

    lg_fit = jax.jit(partial(sharded_lg_fit, mesh))
    bic = jax.jit(partial(sharded_batched_bic, mesh))
    out["sharded_lg_fit"] = (
        lambda: np.concatenate(
            [np.asarray(a).reshape(F, -1) for a in lg_fit(*lg)], axis=1),
        fit_one,
        _lg_fit_close(want, beta_atol=1e-5, var_rtol=VAR_RTOL),
    )
    out["sharded_batched_bic"] = (
        lambda: np.asarray(bic(*lg)),
        lambda: np.asarray(batched_bic(*lg1)),
        _bic_close(lambda: want()[2], bic_atol(n_rows)),
    )

    # KDE slogl with train rows sharded over 'data', both collective forms
    tw = jnp.asarray(rng.normal(size=(n_train, 2)).astype(np.float32))
    sw = jnp.asarray(rng.normal(size=(1024, 2)).astype(np.float32))
    ln = jnp.float32(-math.log(n_train) - LOG_2PI)
    mesh1 = type(mesh)(np.asarray([[one]]), mesh.axis_names)
    ref_kde = lambda: np.asarray(sharded_kde_slogl(mesh1, tw, sw, ln))  # noqa: E731
    for lse in (_lse_all_gather, _lse_pmax_psum):
        out["sharded_kde_slogl" + lse.__name__[4:]] = (
            lambda f=jax.jit(partial(_sharded_kde_slogl, mesh, lse=lse)):
                np.asarray(f(tw, sw, ln)),
            ref_kde,
            _close(1e-5, "shifted exp-sums combined across cards vs one "
                   "card's logsumexp, float32"),
        )

    # NUTS chains sharded over 'data' against the same chains on one card
    gframe = linear_frame(10_000, 4, seed)
    from pybnesian_tpu import GaussianNetwork
    from pybnesian_tpu.inference import make_logdensity

    names = list(gframe)
    gmodel = GaussianNetwork(names, [(names[i - 1], names[i])
                                     for i in range(1, 4)])
    gmodel.fit(gframe)
    logp, _, init = make_logdensity(gmodel, gframe)
    key = jax.random.PRNGKey(seed)
    n_chains = mesh.shape["data"]
    kw = dict(method="nuts", num_samples=num_samples, num_warmup=num_samples)
    out["sample_chains_sharded"] = (
        lambda: np.asarray(sample_chains_sharded(
            logp, init, key, mesh, axis="data", chains_per_device=1, **kw)[0]),
        lambda: np.asarray(sample_chains(logp, init, key,
                                         num_chains=n_chains, **kw)[0]),
        _chain_means_close(0.05),
    )
    return out


def _close(rtol, reason, atol=0.0):
    """|got − want| ≤ atol + rtol·|want| elementwise (numpy allclose)."""
    def compare(got, want):
        max_abs, max_rel = _diffs(got, want)
        want = np.asarray(want, np.float64)
        excess = np.abs(np.asarray(got, np.float64) - want) - (
            atol + rtol * np.abs(want))
        if excess.max() > 0:
            raise AssertionError(
                f"sharded vs one card: max abs diff {max_abs:.3e}, max rel "
                f"diff {max_rel:.3e} outside rtol={rtol} atol={atol}")
        return {"max_abs_diff": max_abs, "max_rel_diff": max_rel,
                "tolerance": {"rtol": rtol, "atol": atol, "reason": reason}}
    return compare


def _lg_fit_close(oracle, beta_atol, var_rtol):
    """Betas within ``beta_atol`` and variances within ``var_rtol`` of the
    float64 oracle, for the mesh and for one card; the mesh against one
    card is reported."""
    def compare(got, single):
        betas, variances, _ = oracle()
        out = {}
        for label, arr in (("sharded", got), ("one_card", single)):
            b_abs, _ = _diffs(arr[:, :-1], betas)
            v_abs, v_rel = _diffs(arr[:, -1], variances)
            _check(f"{label} LG betas vs float64", b_abs, 0.0, atol=beta_atol)
            _check(f"{label} LG variances vs float64", v_abs, v_rel,
                   rtol=var_rtol)
            out[label] = {"beta_max_abs_diff": b_abs,
                          "variance_max_rel_diff": v_rel}
        b_abs, _ = _diffs(got[:, :-1], single[:, :-1])
        _, v_rel = _diffs(got[:, -1], single[:, -1])
        out["sharded_vs_one_card"] = {"beta_max_abs_diff": b_abs,
                                      "variance_max_rel_diff": v_rel}
        out["tolerance"] = {"beta_atol": beta_atol, "variance_rtol": var_rtol,
                            "reason": (
            "against float64 least squares; betas: 1% of their sampling sd "
            "at 1e6 rows; variances: 2e-6 relative moves a BIC score by 1 "
            "unit at 1e6 rows")}
        return out
    return compare


def _bic_close(oracle, atol):
    """BIC scores within ``atol`` BIC units of the float64 oracle, for the
    mesh and for one card; the mesh against one card is reported."""
    def compare(got, single):
        want = oracle()
        out = {}
        for label, arr in (("sharded", got), ("one_card", single)):
            max_abs, max_rel = _diffs(arr, want)
            _check(f"{label} BIC vs float64", max_abs, max_rel, atol=atol)
            out[label] = {"max_abs_diff": max_abs, "max_rel_diff": max_rel}
        max_abs, max_rel = _diffs(got, single)
        out["sharded_vs_one_card"] = {"max_abs_diff": max_abs,
                                      "max_rel_diff": max_rel}
        out["tolerance"] = {"atol": atol, "reason": (
            "BIC units against float64 least squares: a variance error of "
            "2e-6 relative; 1 unit at 1e6 rows")}
        return out
    return compare


def _chain_means_close(atol):
    """Same keys and inits, so the chains start identical; float32 rounding
    that differs between the two programs can flip one NUTS U-turn and send
    a chain down another (equally valid) path, so each chain's posterior
    mean is compared, not every draw."""
    def compare(got, want):
        max_abs, max_rel = _diffs(got.mean(axis=1), want.mean(axis=1))
        _check("chain posterior means", max_abs, max_rel, atol=atol)
        draws_abs, _ = _diffs(got, want)
        return {"max_abs_diff": max_abs, "max_rel_diff": max_rel,
                "max_abs_diff_draws": draws_abs,
                "tolerance": {"atol": atol, "reason": (
                    "per-chain posterior means, 200 draws; posterior sd "
                    "~0.01-0.015 at 1e4 rows")}}
    return compare


# -------------------------------------------------------------------- main
def card_line() -> str:
    """The card's name and power limit, read without touching JAX."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def _precision():
    import jax

    return (jax.config.jax_default_matmul_precision
            or "default, with HIGHEST at every Gram/distance/whitening call")


def run_phase(name, build, failures):
    """Build the phase, time its workload twice, check the result, print
    one JSON line. A failure is printed and recorded, never ignored."""
    line = {"phase": name, "ok": False, "matmul_precision": _precision()}
    try:
        work, check = build()
        t0 = time.perf_counter()
        work()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = work()
        steady = time.perf_counter() - t0
        line["seconds"] = {"first_call": first, "steady": steady,
                           "compile_estimate": max(first - steady, 0.0)}
        line.update(check(result))
        line["ok"] = True
    except Exception as exc:  # reported, then the script exits non-zero
        traceback.print_exc()
        line["error"] = f"{type(exc).__name__}: {exc}"
        failures.append(name)
    print(json.dumps(line, default=str), flush=True)
    return line


def run_mesh(seed, failures):
    from pybnesian_tpu.parallel import data_fam_mesh

    mesh = data_fam_mesh(4, fam=2)
    cases = phase_mesh(mesh, seed=seed)
    for name, (sharded, single, compare) in cases.items():
        def build(sharded=sharded, single=single, compare=compare):
            def check(got):
                if not np.all(np.isfinite(got)):
                    raise AssertionError("non-finite sharded result")
                return compare(got, single())
            return sharded, check
        run_phase(name, build, failures)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh phase, on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    print(card_line(), flush=True)
    import jax

    from pybnesian_tpu.runtime.config import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX runs on {devices[0].platform}", file=sys.stderr)
        return 2
    if args.four_cards and len(devices) < 4:
        print(f"--four-cards needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    enable_compile_cache()

    failures: list[str] = []
    if args.four_cards:
        run_mesh(args.seed, failures)
    else:
        s = args.seed
        learned = {}
        run_phase("ckde_cv", lambda: phase_ckde_cv(seed=s), failures)
        run_phase("hc_spbn", lambda: phase_hc_spbn(seed=s, keep=learned),
                  failures)
        run_phase("hc_bic", lambda: phase_hc_bic(seed=s), failures)
        run_phase("slogl", lambda: phase_slogl(learned["model"],
                                               learned["frame"]), failures)
        run_phase("rcot", lambda: phase_rcot(seed=s), failures)
        run_phase("pc", lambda: phase_pc(seed=s), failures)
        run_phase("nuts", lambda: phase_nuts(seed=s), failures)
    if failures:
        print(f"failed phases: {failures}", file=sys.stderr)
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
