"""Device kernels for the CMIknn (Runge 2018) conditional-independence test.

Batched restructuring of the reference's serial kd-tree pipeline
(continuous/mutual_information.cpp + kdtree/): pairwise Chebyshev distance
matrices are computed once on device; the k-NN radius is a top_k; all
permutations of the shuffle test run through one jitted lax.map, reusing the
fixed y/z distance blocks — only the x distances change per permutation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma


def _pairwise_abs(a):
    """(N, N) |a_i - a_j| for a 1-D vector."""
    return jnp.abs(a[:, None] - a[None, :])


@partial(jax.jit, static_argnames=("k",))
def cmi_knn_pair(x, y, k):
    """Kraskov MI estimate for ranked 1-D x, y
    (reference mi_pair, mutual_information.cpp:9-42)."""
    n = x.shape[0]
    dx = _pairwise_abs(x)
    dy = _pairwise_abs(y)
    joint = jnp.maximum(dx, dy)
    # distance to the k-th neighbour excluding self (self-distance 0 is the
    # smallest entry, so index k of the ascending row)
    neg_topk, _ = jax.lax.top_k(-joint, k + 1)
    eps = -neg_topk[:, k]
    n_x = jnp.sum(dx < eps[:, None], axis=1)
    n_y = jnp.sum(dy < eps[:, None], axis=1)
    res = -jnp.mean(digamma(n_x.astype(x.dtype)) + digamma(n_y.astype(x.dtype)))
    return res + digamma(float(k)) + digamma(float(n))


@partial(jax.jit, static_argnames=("k",))
def cmi_knn_conditional(x, y, dz, k):
    """CMI estimate for ranked x, y given z with precomputed pairwise
    Chebyshev z-distances (reference mi_triple/mi_general,
    mutual_information.cpp:44-135)."""
    dx = _pairwise_abs(x)
    dy = _pairwise_abs(y)
    joint = jnp.maximum(jnp.maximum(dx, dy), dz)
    neg_topk, _ = jax.lax.top_k(-joint, k + 1)
    eps = -neg_topk[:, k]
    within_z = dz < eps[:, None]
    n_z = jnp.sum(within_z, axis=1)
    n_xz = jnp.sum(within_z & (dx < eps[:, None]), axis=1)
    n_yz = jnp.sum(within_z & (dy < eps[:, None]), axis=1)
    f = x.dtype
    res = jnp.mean(
        digamma(n_z.astype(f)) - digamma(n_xz.astype(f)) - digamma(n_yz.astype(f))
    )
    return res + digamma(float(k))


@partial(jax.jit, static_argnames=("k",))
def cmi_knn_pair_batch(xs, y, k):
    """MI for S permutations of x against fixed y in one call.
    xs: (S, N)."""

    def one(x):
        return cmi_knn_pair(x, y, k)

    return jax.lax.map(one, xs)


@partial(jax.jit, static_argnames=("k",))
def cmi_knn_conditional_batch(xs, y, dz, k):
    """CMI for S locally-shuffled x vectors against fixed y, z. xs: (S, N)."""

    def one(x):
        return cmi_knn_conditional(x, y, dz, k)

    return jax.lax.map(one, xs)


@partial(jax.jit, static_argnames=("k",))
def cmi_knn_pair_tests(xs_t, ys_t, k):
    """MI for T tests × S permutations in ONE launch: xs_t (T, S, N)
    against per-test ys_t (T, N). Returns (T, S). Cross-test batching for
    the PC sweep (each extra launch costs a dispatch round trip)."""

    def one_test(args):
        xs, y = args
        return jax.lax.map(lambda x: cmi_knn_pair(x, y, k), xs)

    return jax.lax.map(one_test, (xs_t, ys_t))


@partial(jax.jit, static_argnames=("k",))
def cmi_knn_conditional_tests(xs_t, ys_t, dz_t, k):
    """CMI for T tests × S draws in ONE launch: xs_t (T, S, N), ys_t
    (T, N), dz_t (T, N, N). Returns (T, S)."""

    def one_test(args):
        xs, y, dz = args
        return jax.lax.map(lambda x: cmi_knn_conditional(x, y, dz, k), xs)

    return jax.lax.map(one_test, (xs_t, ys_t, dz_t))
