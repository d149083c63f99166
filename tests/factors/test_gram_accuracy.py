"""The centred, row-blocked family Gram of ops/gaussian.py: its layout, its
block sums, and float32 LG fits and BIC scores against float64 least
squares on data whose column means are far from zero."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from pybnesian_tpu.ops import gaussian


def _chain(n, d, loc, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    for j in range(1, d):
        x[:, j] += 0.7 * x[:, j - 1]
    return x + loc * np.arange(1, d + 1)


def _ols(y, X):
    A = np.column_stack([np.ones(len(y)), X])
    beta = np.linalg.lstsq(A, y, rcond=None)[0]
    return beta, float(np.sum((y - A @ beta) ** 2))


@pytest.mark.parametrize("block", [16, 100, 4096])
def test_family_gram_layout_and_blocks(monkeypatch, block):
    """Row 0 holds [n_eff, weighted means]; the rest the weighted moments
    about those means, whatever the block size (n = 250 is no multiple of
    16 or 100, and smaller than 4096)."""
    monkeypatch.setattr(gaussian, "GRAM_BLOCK", block)
    rng = np.random.default_rng(1)
    z = rng.normal(3.0, 2.0, size=(250, 3))
    w = (rng.uniform(size=250) > 0.2).astype(np.float64)
    gram = np.asarray(gaussian.family_gram(jnp.asarray(z), jnp.asarray(w)))
    n_eff = w.sum()
    mean = (w[:, None] * z).sum(0) / n_eff
    zc = z - mean
    np.testing.assert_allclose(gram[0, 0], n_eff)
    np.testing.assert_allclose(gram[0, 1:], mean, rtol=1e-12)
    np.testing.assert_allclose(gram[1:, 0], mean, rtol=1e-12)
    np.testing.assert_allclose(gram[1:, 1:], (w[:, None] * zc).T @ zc,
                               rtol=1e-12)


@pytest.mark.parametrize("n", [3000, 20_000])
@pytest.mark.parametrize("loc", [0.0, 40.0])
def test_float32_lg_fit_and_bic_vs_float64(n, loc):
    """float32 betas, variances and BIC within the bounds chip_smoke.py
    holds the GPU to (variance 2e-6 relative), also with means of 40-160
    that an uncentred float32 Gram cancels against."""
    d = 4
    data = _chain(n, d, loc)
    values = jnp.asarray(data.astype(np.float32))
    valid = jnp.ones_like(values)
    fams = [(0, []), (1, [0]), (2, [1, 0]), (3, [2, 1, 0])]
    P = 3
    var_idx = np.array([v for v, _ in fams], np.int32)
    parent_idx = np.zeros((len(fams), P), np.int32)
    parent_mask = np.zeros((len(fams), P), np.float32)
    for f, (_, ps) in enumerate(fams):
        parent_idx[f, : len(ps)] = ps
        parent_mask[f, : len(ps)] = 1.0
    args = (values, valid, jnp.asarray(var_idx), jnp.asarray(parent_idx),
            jnp.asarray(parent_mask))
    grams, n_eff = gaussian.family_grams(*args)
    betas, variances, _ = gaussian.batched_lg_params(grams, args[4], n_eff)
    scores = gaussian.batched_bic(*args)
    assert betas.dtype == jnp.float32 and scores.dtype == jnp.float32
    x64 = np.asarray(values, np.float64)
    for f, (v, ps) in enumerate(fams):
        beta, rss = _ols(x64[:, v], x64[:, ps])
        k = len(ps)
        var = rss / (n - k - 1)
        bic = (0.5 * (1 + k - n) - 0.5 * n * math.log(2 * math.pi)
               - 0.5 * n * math.log(var) - 0.5 * math.log(n) * (k + 2))
        np.testing.assert_allclose(float(variances[f]), var, rtol=2e-6)
        np.testing.assert_allclose(np.asarray(betas[f, 1 : k + 1]), beta[1:],
                                   atol=1e-5)
        # the intercept carries the means: bounded relative to them
        np.testing.assert_allclose(float(betas[f, 0]), beta[0],
                                   atol=1e-5 * (1 + loc * d))
        assert abs(float(scores[f]) - bic) <= 0.5 * n * 2e-6
