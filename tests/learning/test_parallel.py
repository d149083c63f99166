"""Multi-device SPMD kernels on the virtual CPU mesh (8 devices via
conftest XLA flags)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pybnesian_tpu.learning.scores.likelihood import CVLikelihood
from pybnesian_tpu.models import GaussianNetwork, KDENetwork
from pybnesian_tpu.parallel import (
    data_fam_mesh,
    make_mesh,
    sharded_batched_bic,
    sharded_ckde_cv,
    sharded_kde_slogl,
    sharded_lg_fit,
)
from pybnesian_tpu.learning.scores import BIC
from data_gen import normal_chain_data


def test_sharded_bic_matches_host():
    df = normal_chain_data(512)
    score = BIC(df)
    model = GaussianNetwork(["a", "b", "c", "d"])
    mesh = make_mesh({"data": 4, "fam": 2})
    values, valid = score.df.device_matrix(["a", "b", "c", "d"])
    fams = [("a", []), ("b", ["a"]), ("c", ["a", "b"]), ("d", ["c"])]
    var_idx = np.array([0, 1, 2, 3], np.int32)
    parent_idx = np.zeros((4, 2), np.int32)
    parent_mask = np.zeros((4, 2))
    for f, (_, ps) in enumerate(fams):
        for j, p in enumerate(ps):
            parent_idx[f, j] = {"a": 0, "b": 1, "c": 2, "d": 3}[p]
            parent_mask[f, j] = 1.0
    out = sharded_batched_bic(
        mesh, values, valid, jnp.asarray(var_idx), jnp.asarray(parent_idx),
        jnp.asarray(parent_mask),
    )
    for f, (v, ps) in enumerate(fams):
        np.testing.assert_allclose(
            float(out[f]), score.local_score(model, v, ps), rtol=1e-8
        )


def test_sharded_lg_fit_matches_mle():
    from pybnesian_tpu.learning.parameters import mle_lineargaussian

    df = normal_chain_data(512)
    score = BIC(df)
    mesh = make_mesh({"data": 8, "fam": 1})
    values, valid = score.df.device_matrix(["a", "b", "c", "d"])
    var_idx = jnp.asarray(np.array([1], np.int32))
    parent_idx = jnp.asarray(np.array([[0, 0]], np.int32))
    parent_mask = jnp.asarray(np.array([[1.0, 0.0]]))
    betas, variances = sharded_lg_fit(
        mesh, values, valid, var_idx, parent_idx, parent_mask
    )
    ref = mle_lineargaussian(df, "b", ["a"])
    np.testing.assert_allclose(np.asarray(betas[0, :2]), ref.beta, rtol=1e-7)
    np.testing.assert_allclose(float(variances[0]), ref.variance, rtol=1e-7)


def test_sharded_ckde_cv_matches_serial():
    df = normal_chain_data(400)
    score = CVLikelihood(df, 5, seed=0)
    model = KDENetwork(["a", "b", "c", "d"])
    # serial references through the standard path (also warms the engine)
    fams = [("a", []), ("b", ["a"]), ("c", ["b"]), ("d", ["c"])]
    ref = np.array([score.local_score(model, v, ps) for v, ps in fams])
    eng = score._engine
    pos, data, null_mask, tr_idx, tr_mask, te_idx, te_mask, dtype = (
        eng._device_cv_cache()
    )
    F = 8  # pad to the fam axis
    col_idx = np.zeros((F, 2), np.int32)
    col_mask = np.zeros((F, 2), dtype)
    col_mask[:, 0] = 1.0
    for f, (v, ps) in enumerate(fams):
        # kernel layout: evidence first, variable last
        for j, c in enumerate([*ps, v]):
            col_idx[f, j] = pos[c]
            col_mask[f, j] = 1.0
    mesh = make_mesh({"data": 2, "fam": 4})
    out = sharded_ckde_cv(
        mesh, data, null_mask, jnp.asarray(col_idx), jnp.asarray(col_mask),
        tr_idx, tr_mask, te_idx, te_mask,
    )
    np.testing.assert_allclose(np.asarray(out)[:4], ref, rtol=1e-6)


def test_sharded_kde_slogl():
    from scipy.special import logsumexp

    rng = np.random.default_rng(0)
    train = rng.normal(0, 2, (64, 2))
    test = rng.normal(0, 2, (16, 2))
    mesh = make_mesh({"data": 8})
    out = sharded_kde_slogl(
        mesh, jnp.asarray(train), jnp.asarray(test), jnp.asarray(-1.0)
    )
    ref = (
        logsumexp(
            -0.5 * ((test[:, None, :] - train[None, :, :]) ** 2).sum(-1),
            axis=1,
        )
        - 1.0
    ).sum()
    np.testing.assert_allclose(float(out), ref, rtol=1e-8)


@pytest.mark.parametrize("form", ["_lse_all_gather", "_lse_pmax_psum"])
def test_sharded_kde_slogl_forms(form):
    """Both cross-shard logsumexp forms, whichever the platform picks."""
    from scipy.special import logsumexp

    from pybnesian_tpu import parallel

    rng = np.random.default_rng(1)
    train = rng.normal(0, 2, (96, 2))
    test = rng.normal(0, 2, (8, 2))
    mesh = make_mesh({"data": 4})
    out = parallel._sharded_kde_slogl(
        mesh, jnp.asarray(train), jnp.asarray(test), jnp.asarray(-1.0),
        lse=getattr(parallel, form),
    )
    ref = (logsumexp(-0.5 * ((test[:, None, :] - train[None, :, :]) ** 2)
                     .sum(-1), axis=1) - 1.0).sum()
    np.testing.assert_allclose(float(out), ref, rtol=1e-8)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    n = min(8, len(jax.devices()))
    ge.dryrun_multichip(n)
