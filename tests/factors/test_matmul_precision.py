"""The float32 Gram and cross-product matmuls on the main path ask for
Precision.HIGHEST: the default lets a GPU run them in TF32 (about three
decimal digits), which breaks the uncentred-Gram cancellation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _dot_precisions(fn, *args):
    """Precision of every dot_general in the jaxpr of fn(*args)."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _is_highest(p):
    hi = jax.lax.Precision.HIGHEST
    return p is not None and all(q == hi for q in (
        p if isinstance(p, tuple) else (p, p)))


def _lg_args(F=3, n=40, D=4, K=2):
    rng = np.random.default_rng(0)
    f32 = np.float32
    return dict(
        values=jnp.asarray(rng.normal(size=(n, D)).astype(f32)),
        valid=jnp.ones((n, D), f32),
        train_mask=jnp.ones((K, n), f32),
        test_mask=jnp.ones((K, n), f32),
        var_idx=jnp.arange(F, dtype=jnp.int32),
        parent_idx=jnp.ones((F, 2), jnp.int32),
        parent_mask=jnp.ones((F, 2), f32),
    )


@pytest.mark.parametrize("kernel", ["family_grams", "batched_bic",
                                    "batched_lg_cv_loglik"])
def test_gaussian_grams_are_highest(kernel):
    from pybnesian_tpu.ops import gaussian

    a = _lg_args()
    if kernel == "batched_lg_cv_loglik":
        args = (a["values"], a["valid"], a["train_mask"], a["test_mask"],
                a["var_idx"], a["parent_idx"], a["parent_mask"])
    else:
        args = (a["values"], a["valid"], a["var_idx"], a["parent_idx"],
                a["parent_mask"])
    precs = _dot_precisions(getattr(gaussian, kernel), *args)
    assert precs and all(_is_highest(p) for p in precs), precs


def test_sharded_gram_is_highest():
    from pybnesian_tpu.parallel import make_mesh, sharded_batched_bic

    a = _lg_args(F=2)
    mesh = make_mesh({"data": 2, "fam": 1})
    precs = _dot_precisions(
        lambda v, m: sharded_batched_bic(mesh, v, m, a["var_idx"],
                                         a["parent_idx"], a["parent_mask"]),
        a["values"], a["valid"])
    assert precs and all(_is_highest(p) for p in precs), precs


def test_rcot_grams_are_highest():
    from pybnesian_tpu.learning.independences.rcot import _get_batched

    rng = np.random.default_rng(1)
    f32 = np.float32
    B, n, C, fxy, fz, dz = 2, 32, 4, 3, 4, 2
    fused_z, pair_stats = _get_batched()
    args = (
        jnp.asarray(rng.normal(size=(n, C)).astype(f32)),
        jnp.zeros(B, jnp.int32), jnp.ones((B, fxy), f32),
        jnp.zeros((B, fxy), f32), jnp.ones(B, jnp.int32),
        jnp.ones((B, fxy), f32), jnp.zeros((B, fxy), f32),
        jnp.full((B, dz), 2, jnp.int32), jnp.ones((B, dz), f32),
        jnp.ones((B, dz, fz), f32), jnp.zeros((B, fz), f32),
    )
    precs = _dot_precisions(fused_z, *args)
    assert precs and all(_is_highest(p) for p in precs), precs
    precs = _dot_precisions(pair_stats, *args[:7])
    assert precs and all(_is_highest(p) for p in precs), precs


def test_ckde_cv_whitening_is_highest():
    from pybnesian_tpu.ops.kde import ckde_cv_alldevice

    rng = np.random.default_rng(2)
    f32 = np.float32
    n, K = 64, 2
    args = (
        jnp.asarray(rng.normal(size=(n, 3)).astype(f32)),
        jnp.zeros((n, 3), f32),
        jnp.asarray([[0, 1]], jnp.int32), jnp.ones((1, 2), f32),
        jnp.tile(jnp.arange(32, dtype=jnp.int32), (K, 1)),
        jnp.ones((K, 32), f32),
        jnp.tile(jnp.arange(32, 64, dtype=jnp.int32), (K, 1)),
        jnp.ones((K, 32), f32),
    )
    precs = _dot_precisions(
        lambda *a: ckde_cv_alldevice(*a, chunk=32), *args)
    assert precs and all(_is_highest(p) for p in precs), precs
