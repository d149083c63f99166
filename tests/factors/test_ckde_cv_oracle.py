"""ckde_cv_alldevice against a float64 numpy oracle of the reference's CKDE
CV log-likelihood (kde/KDE.hpp normal-reference / Scott bandwidth on the
training fold, CKDE.hpp:182-254 marginal on the joint bandwidth's evidence
block, null rows dropped per family)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import solve_triangular
from scipy.special import logsumexp

from pybnesian_tpu.ops.kde import ckde_cv_alldevice


def _kde_logl(train, test, H):
    L = np.linalg.cholesky(H)
    tw = solve_triangular(L, train.T, lower=True).T
    sw = solve_triangular(L, test.T, lower=True).T
    d2 = ((sw[:, None, :] - tw[None, :, :]) ** 2).sum(-1)
    d = train.shape[1]
    return (logsumexp(-0.5 * d2, axis=1) - np.log(np.diag(L)).sum()
            - 0.5 * d * math.log(2 * math.pi) - math.log(len(train)))


def _oracle(data, null, cols, folds, rule):
    """cols: evidence first, variable last."""
    mat = data[:, cols].astype(np.float64)
    ok = ~null[:, cols].any(axis=1)
    d = len(cols)
    total = 0.0
    for tr, te in folds:
        train = mat[tr[ok[tr]]]
        test = mat[te[ok[te]]]
        n = len(train)
        if rule == "nr":
            k = (4.0 / (n * (d + 2.0))) ** (2.0 / (d + 4.0))
        else:
            k = n ** (-2.0 / (d + 4.0))
        H = k * np.cov(train, rowvar=False, ddof=1).reshape(d, d)
        ll = _kde_logl(train, test, H)
        if d > 1:
            ll = ll - _kde_logl(train[:, :-1], test[:, :-1], H[:-1, :-1])
        total += ll.sum()
    return total


@pytest.mark.parametrize("null_share", [0.0, 0.1])
@pytest.mark.parametrize("djmax", [2, 4])
@pytest.mark.parametrize("rule", ["nr", "scott"])
def test_ckde_cv_alldevice_matches_float64_oracle(rule, djmax, null_share):
    rng = np.random.default_rng(7 + djmax)
    n, D, K = 360, 5, 3
    data = rng.normal(0, 1.0, (n, D))
    for j in range(1, D):
        data[:, j] += np.sin(data[:, j - 1])
    null = rng.random((n, D)) < null_share
    data_z = np.where(null, 0.0, data)

    fams = [[0], [1, 2], [3, 0, 4][: min(3, djmax)], list(range(djmax))]
    col_idx = np.zeros((len(fams), djmax), np.int32)
    col_mask = np.zeros((len(fams), djmax))
    for f, cols in enumerate(fams):
        col_idx[f, : len(cols)] = cols
        col_mask[f, : len(cols)] = 1.0

    perm = rng.permutation(n)
    folds_te = np.array_split(perm, K)
    folds = [(np.concatenate([folds_te[j] for j in range(K) if j != k]),
              folds_te[k]) for k in range(K)]
    ntr = max(len(tr) for tr, _ in folds)
    nte = 128
    tr_idx = np.zeros((K, ntr), np.int32)
    tr_mask = np.zeros((K, ntr))
    te_idx = np.zeros((K, nte), np.int32)
    te_mask = np.zeros((K, nte))
    for k, (tr, te) in enumerate(folds):
        tr_idx[k, : len(tr)] = tr
        tr_mask[k, : len(tr)] = 1.0
        te_idx[k, : len(te)] = te
        te_mask[k, : len(te)] = 1.0

    out = np.asarray(ckde_cv_alldevice(
        jnp.asarray(data_z), jnp.asarray(null.astype(np.float64)),
        jnp.asarray(col_idx), jnp.asarray(col_mask), jnp.asarray(tr_idx),
        jnp.asarray(tr_mask), jnp.asarray(te_idx), jnp.asarray(te_mask),
        chunk=128, rule=rule,
    ))
    want = [_oracle(data, null, cols, folds, rule) for cols in fams]
    np.testing.assert_allclose(out, want, rtol=1e-9)
