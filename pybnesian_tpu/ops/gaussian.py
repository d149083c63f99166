"""Device kernels for linear-Gaussian factors and scores.

The batched replacement for the reference's per-family Eigen closed forms
(reference learning/parameters/mle_LinearGaussianCPD.{hpp,cpp} and
learning/scores/bic.cpp:12-27). Instead of fitting one family at a time on
host, *batches of candidate families* (the unit of work of structure search)
are evaluated in a single vmapped kernel:

- each family (variable, parent-set) is encoded as a variable index + padded
  parent-index vector + 0/1 parent mask (ragged parent sets → static shapes);
- null handling is a per-row validity weight (product of the family columns'
  validity), reproducing the reference's pairwise-deletion semantics
  (dataset/dataset.hpp:238-335) without dynamic shapes;
- sufficient statistics are one masked, centred Gram matrix per family
  (:func:`family_gram`) followed by a tiny masked solve.

The Grams take the data's dtype, and are built to keep float32's
precision when that is float32: every matmul runs at ``Precision.HIGHEST`` (the default lets a
GPU use TF32, which keeps about three decimal digits); the columns are
centred on their means first, so ``rss = syy − β·sxy`` does not cancel
against the squared means; and the rows are summed in blocks of
:data:`GRAM_BLOCK`, then across blocks, instead of in one float32 sum over
all n rows, whose rounding grows with n.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

LOG_2PI = math.log(2.0 * math.pi)
HIGHEST = jax.lax.Precision.HIGHEST
_MACHINE_TOL = 2.220446049250313e-16 * 4
#: Rows per partial Gram: each partial is a float32 sum of at most this
#: many products, and the partials are summed afterwards.
GRAM_BLOCK = 1024


def _family_columns(values, valid, var_idx, parent_idx, parent_mask):
    """Family columns [parents(masked), y] (n, P+1) and row weights (n,)."""
    y = values[:, var_idx]
    X = values[:, parent_idx] * parent_mask[None, :]
    w = valid[:, var_idx] * jnp.prod(
        jnp.where(parent_mask[None, :] > 0, valid[:, parent_idx], 1.0), axis=1
    )
    return jnp.concatenate([X, y[:, None]], axis=1), w


def _column_sums(z, w):
    """(Σ_n w_n·z_n, Σ_n w_n)."""
    return jnp.sum(z * w[:, None], axis=0), jnp.sum(w)


def _centred_moments(z, w, mean):
    """Σ_n w_n·(z_n − mean)(z_n − mean)ᵀ, summed over blocks of
    :data:`GRAM_BLOCK` rows and then across the blocks."""
    n, k = z.shape
    block = min(GRAM_BLOCK, n)
    nb = -(-n // block)
    zc = z - mean[None, :]
    pad = ((0, nb * block - n), (0, 0))
    a = jnp.pad(zc * w[:, None], pad).reshape(nb, block, k)
    b = jnp.pad(zc, pad).reshape(nb, block, k)
    parts = jnp.einsum(
        "bni,bnj->bij", a, b,
        precision=HIGHEST, preferred_element_type=z.dtype,
    )
    return jnp.sum(parts, axis=0)


def family_gram(z, w, reduce=lambda t: t):
    """Centred Gram of family columns ``z`` (n, P+1) under row weights ``w``.

    Returns (P+2, P+2): entry [0, 0] is n_eff = Σ w, row and column 0 hold
    the weighted column means, and the lower-right block the moments about
    those means. ``reduce`` combines partial sums across devices (a psum
    over the mesh's row axis); it is called on the column sums and then on
    the moments."""
    sums, n_eff = reduce(_column_sums(z, w))
    mean = sums / jnp.maximum(n_eff, 1.0)
    moments = reduce(_centred_moments(z, w, mean))
    top = jnp.concatenate([n_eff[None], mean])
    rest = jnp.concatenate([mean[:, None], moments], axis=1)
    return jnp.concatenate([top[None, :], rest], axis=0)


@jax.jit
def family_grams(values, valid, var_idx, parent_idx, parent_mask):
    """Masked, centred Gram matrices (:func:`family_gram`) for F families.

    values: (n, D) data (nulls zeroed), valid: (n, D) 0/1 validity,
    var_idx: (F,) int, parent_idx: (F, P) int, parent_mask: (F, P) 0/1.
    Returns grams (F, P+2, P+2) over columns [parents, y] and n_eff (F,).
    """

    def one(vi, pi, pm):
        z, w = _family_columns(values, valid, vi, pi, pm)
        gram = family_gram(z, w)
        return gram, gram[0, 0]

    return jax.vmap(one)(var_idx, parent_idx, parent_mask)


def lg_params_from_gram(gram, parent_mask, n_eff):
    """(beta, variance, rss) from one centred family Gram
    (:func:`family_gram`; reference mle_LinearGaussianCPD.hpp closed forms,
    generalized).

    beta is padded to P+1 entries [intercept, slopes]; masked-out parents get
    slope 0. variance = RSS / (n - k - 1), +inf when underdetermined
    (mle_LinearGaussianCPD.hpp:203-230, :173-186)."""
    m = parent_mask
    P = m.shape[0]
    mean_x = gram[0, 1 : P + 1]
    mean_y = gram[0, P + 1]
    S = gram[1 : P + 1, 1 : P + 1] * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
    sxy = gram[1 : P + 1, P + 1] * m
    syy = gram[P + 1, P + 1]
    # the centred moment matrix is SPD: a Cholesky solve, at every dtype.
    chol = jnp.linalg.cholesky(S)
    slopes = jax.scipy.linalg.cho_solve((chol, True), sxy)
    intercept = mean_y - jnp.dot(slopes, mean_x, precision=HIGHEST)
    beta = jnp.concatenate([intercept[None], slopes])
    rss = syy - jnp.dot(slopes, sxy, precision=HIGHEST)
    rss = jnp.maximum(rss, 0.0)
    k = jnp.sum(parent_mask)
    dof = n_eff - k - 1.0
    variance = jnp.where(dof > 0, rss / jnp.maximum(dof, 1.0), jnp.inf)
    return beta, variance, rss


@jax.jit
def batched_lg_params(grams, parent_mask, n_eff):
    return jax.vmap(lg_params_from_gram)(grams, parent_mask, n_eff)


def bic_from_gram(gram, parent_mask, n_eff):
    """Gaussian BIC local score from a family Gram
    (formula: reference learning/scores/bic.cpp:12-27)."""
    _, variance, _ = lg_params_from_gram(gram, parent_mask, n_eff)
    k = jnp.sum(parent_mask)
    n = n_eff
    loglik = (
        0.5 * (1.0 + k - n) - 0.5 * n * LOG_2PI - 0.5 * n * jnp.log(variance)
    )
    score = loglik - 0.5 * jnp.log(n) * (k + 2.0)
    bad = (
        (variance < _MACHINE_TOL)
        | ~jnp.isfinite(variance)
        | ~jnp.isfinite(score)
    )
    return jnp.where(bad, -jnp.inf, score)


@jax.jit
def batched_bic(values, valid, var_idx, parent_idx, parent_mask):
    """BIC local score for F candidate families in one device call."""
    grams, n_eff = family_grams(values, valid, var_idx, parent_idx, parent_mask)
    return jax.vmap(bic_from_gram)(grams, parent_mask, n_eff)


@jax.jit
def batched_lg_cv_loglik(values, valid, train_mask, test_mask, var_idx,
                         parent_idx, parent_mask):
    """k-fold CV log-likelihood of F linear-Gaussian families in ONE device
    call — the batched replacement for the reference's per-(family, fold)
    serial fit+slogl loop (learning/scores/cv_likelihood.cpp:11-25).

    train_mask/test_mask: (K, n) 0/1 row masks per fold (rows excluded from
    the CV — e.g. null rows — are 0 in both). Returns (F,) summed test
    log-likelihood across folds; -inf when any fold is degenerate."""

    def one_family(vi, pi, pm):
        z, w = _family_columns(values, valid, vi, pi, pm)
        y = z[:, -1]

        def one_fold(tm, sm):
            gram = family_gram(z, w * tm)
            beta, variance, _ = lg_params_from_gram(gram, pm, gram[0, 0])
            mean = beta[0] + jnp.matmul(z[:, :-1], beta[1:], precision=HIGHEST)
            ll = (
                -0.5 * jnp.square(y - mean) / variance
                - 0.5 * jnp.log(variance)
                - 0.5 * LOG_2PI
            )
            wte = w * sm
            fold_ll = jnp.sum(ll * wte)
            bad = (variance < _MACHINE_TOL) | ~jnp.isfinite(variance)
            return jnp.where(bad, -jnp.inf, fold_ll)

        return jnp.sum(jax.vmap(one_fold)(train_mask, test_mask))

    return jax.vmap(one_family)(var_idx, parent_idx, parent_mask)


@jax.jit
def batched_lg_holdout_loglik(train_values, train_valid, test_values,
                              test_valid, var_idx, parent_idx, parent_mask):
    """Fit on training split, slogl on test split, batched over F families
    (reference learning/scores/holdout_likelihood.cpp)."""
    grams, n_eff = family_grams(
        train_values, train_valid, var_idx, parent_idx, parent_mask
    )
    betas, variances, _ = jax.vmap(lg_params_from_gram)(
        grams, parent_mask, n_eff
    )

    def one(vi, pi, pm, beta, variance):
        z, w = _family_columns(test_values, test_valid, vi, pi, pm)
        y = z[:, -1]
        mean = beta[0] + jnp.matmul(z[:, :-1], beta[1:], precision=HIGHEST)
        ll = (
            -0.5 * jnp.square(y - mean) / variance
            - 0.5 * jnp.log(variance)
            - 0.5 * LOG_2PI
        )
        total = jnp.sum(ll * w)
        bad = (variance < _MACHINE_TOL) | ~jnp.isfinite(variance)
        return jnp.where(bad, -jnp.inf, total)

    return jax.vmap(one)(var_idx, parent_idx, parent_mask, betas, variances)


@jax.jit
def lg_logl(y, X, beta, variance):
    """Per-row log N(y | beta0 + X·beta[1:], variance)
    (reference LinearGaussianCPD.cpp:93-119)."""
    mean = beta[0] + jnp.matmul(X, beta[1:], precision=HIGHEST)
    return (
        -0.5 * jnp.square(y - mean) / variance
        - 0.5 * jnp.log(variance)
        - 0.5 * LOG_2PI
    )


@partial(jax.jit, static_argnames=("batch",))
def batched_lg_logl(values, valid, var_idx, parent_idx, parent_mask, betas,
                    variances, batch=None):
    """slogl of F fitted LG families over the same data in one call.

    Returns (F,) sums over valid rows. Used by CV/holdout likelihood scoring."""

    def one(vi, pi, pm, beta, var):
        y = values[:, vi]
        X = values[:, pi] * pm[None, :]
        w = valid[:, vi] * jnp.prod(
            jnp.where(pm[None, :] > 0, valid[:, pi], 1.0), axis=1
        )
        ll = lg_logl(y, X, beta, var)
        return jnp.sum(ll * w)

    return jax.vmap(one)(var_idx, parent_idx, parent_mask, betas, variances)
