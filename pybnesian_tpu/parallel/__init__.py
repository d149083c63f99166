"""Multi-chip sharding layer: mesh construction + SPMD score/likelihood
kernels.

The reference has no distributed backend at all (SURVEY.md §2.13 — one OpenCL
device, one in-order queue). This module is net-new: a (data, fam) mesh
shards data rows and candidate families; XLA collectives (psum) combine
per-shard sufficient statistics. Works identically on one device, several
devices of one host, or several hosts (jax.distributed + the same Mesh).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ..ops.gaussian import (
    LOG_2PI,
    _MACHINE_TOL,
    _family_columns,
    family_gram,
    lg_params_from_gram,
)

try:  # jax>=0.6 moved shard_map to jax.shard_map
    from jax import shard_map as _shard_map_mod

    shard_map = _shard_map_mod
except ImportError:
    from jax.experimental.shard_map import shard_map

__all__ = [
    "make_mesh",
    "data_fam_mesh",
    "sharded_batched_bic",
    "sharded_lg_fit",
    "sharded_kde_slogl",
    "sharded_ckde_cv",
]


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """Mesh over the available devices, e.g. make_mesh({"data": 4, "fam": 2})."""
    devices = devices if devices is not None else jax.devices()
    names = tuple(axis_sizes.keys())
    shape = tuple(axis_sizes.values())
    total = int(np.prod(shape))
    if total > len(devices):
        raise ValueError(
            f"Mesh of {total} devices requested but only {len(devices)} "
            "available"
        )
    dev_array = np.asarray(devices[:total]).reshape(shape)
    return Mesh(dev_array, names)


def data_fam_mesh(n_devices: int | None = None, fam: int = 1) -> Mesh:
    """Default 2-D (data, fam) mesh using all devices."""
    n = n_devices if n_devices is not None else len(jax.devices())
    if n % fam != 0:
        raise ValueError("fam axis must divide the device count")
    return make_mesh({"data": n // fam, "fam": fam})


def _sharded_family_grams(values, valid, var_idx, parent_idx, parent_mask):
    """Centred family Grams (ops.gaussian.family_gram) of this shard's
    families over the rows of every 'data' shard: one psum of the column
    sums (the shared means), then one of the moments, for the whole batch."""
    psum = partial(jax.lax.psum, axis_name="data")

    def one(vi, pi, pm):
        z, w = _family_columns(values, valid, vi, pi, pm)
        return family_gram(z, w, reduce=psum)

    grams = jax.vmap(one)(var_idx, parent_idx, parent_mask)
    return grams, grams[:, 0, 0]


def sharded_batched_bic(mesh: Mesh, values, valid, var_idx, parent_idx,
                        parent_mask):
    """BIC local scores with rows sharded over the 'data' axis and families
    over 'fam': per-shard Grams are psum-reduced, the tiny solves
    replicate per family shard. Row counts must divide the data axis; family
    count must divide the fam axis (pad upstream)."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("data", None),
            P("data", None),
            P("fam"),
            P("fam", None),
            P("fam", None),
        ),
        out_specs=P("fam"),
    )
    def kernel(v, m, vi, pi, pm):
        grams, n_effs = _sharded_family_grams(v, m, vi, pi, pm)

        def one(gram, n_eff, pm_):
            _, variance, _ = lg_params_from_gram(gram, pm_, n_eff)
            k = jnp.sum(pm_)
            loglik = (
                0.5 * (1.0 + k - n_eff)
                - 0.5 * n_eff * LOG_2PI
                - 0.5 * n_eff * jnp.log(variance)
            )
            score = loglik - 0.5 * jnp.log(n_eff) * (k + 2.0)
            bad = (variance < _MACHINE_TOL) | ~jnp.isfinite(score)
            return jnp.where(bad, -jnp.inf, score)

        return jax.vmap(one)(grams, n_effs, pm)

    return kernel(values, valid, var_idx, parent_idx, parent_mask)


def sharded_lg_fit(mesh: Mesh, values, valid, var_idx, parent_idx,
                   parent_mask):
    """Fit all families' LinearGaussian parameters on the mesh — the
    data-parallel parameter-learning step (MLE for the whole network in one
    SPMD launch)."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P("data", None),
            P("data", None),
            P("fam"),
            P("fam", None),
            P("fam", None),
        ),
        out_specs=(P("fam", None), P("fam")),
    )
    def kernel(v, m, vi, pi, pm):
        grams, n_effs = _sharded_family_grams(v, m, vi, pi, pm)

        def one(gram, n_eff, pm_):
            beta, variance, _ = lg_params_from_gram(gram, pm_, n_eff)
            return beta, variance

        return jax.vmap(one)(grams, n_effs, pm)

    return kernel(values, valid, var_idx, parent_idx, parent_mask)


def sharded_ckde_cv(mesh: Mesh, data, null_mask, col_idx, col_mask, tr_idx,
                    tr_mask, te_idx, te_mask, chunk: int = 256,
                    rule: str = "nr"):
    """CV-likelihood CKDE scoring with candidate families sharded over the
    'fam' mesh axis — the multi-chip form of
    :func:`pybnesian_tpu.ops.kde.ckde_cv_alldevice`. Data and fold indices
    replicate (they are small next to the pairwise compute); each chip scores
    its slice of the candidate-family batch independently, so score
    throughput scales linearly with chips. F must divide the fam axis."""
    from ..ops.kde import ckde_cv_alldevice

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(None, None),  # data replicated
            P(None, None),
            P("fam", None),  # families sharded
            P("fam", None),
            P(None, None),
            P(None, None),
            P(None, None),
            P(None, None),
        ),
        out_specs=P("fam"),
        check_vma=False,
    )
    def kernel(d, nm, ci, cm, tri, trm, tei, tem):
        return ckde_cv_alldevice(
            d, nm, ci, cm, tri, trm, tei, tem, chunk=chunk, rule=rule
        )

    return kernel(
        data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask
    )


def _kde_logits(tr, te):
    tn = jnp.sum(jnp.square(tr), axis=1)
    cross = jnp.dot(
        te, tr.T, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=te.dtype,
    )
    d2 = jnp.sum(jnp.square(te), axis=1)[:, None] - 2.0 * cross + tn[None, :]
    return -0.5 * d2


def _lse_all_gather(logits):
    """Row logsumexp across 'data' shards with ONE collective: each shard
    shifts by its local max and an all_gather moves the (max, shifted sum)
    pairs, a (2·shards·m) payload."""
    local_max = jnp.max(logits, axis=1)
    local_sum = jnp.sum(jnp.exp(logits - local_max[:, None]), axis=1)
    pairs = jax.lax.all_gather(jnp.stack([local_max, local_sum]), "data")
    maxes, sums = pairs[:, 0, :], pairs[:, 1, :]
    gmax = jnp.max(maxes, axis=0)
    return gmax + jnp.log(jnp.sum(sums * jnp.exp(maxes - gmax[None, :]), 0))


def _lse_pmax_psum(logits):
    """Row logsumexp across 'data' shards with two collectives: the global
    max (pmax), then the shifted sums (psum)."""
    gmax = jax.lax.pmax(jnp.max(logits, axis=1), "data")
    total = jax.lax.psum(
        jnp.sum(jnp.exp(logits - gmax[:, None]), axis=1), "data"
    )
    return gmax + jnp.log(total)


def _sharded_kde_slogl(mesh, train_white, test_white, lognorm, lse):
    """sharded_kde_slogl with the cross-shard logsumexp ``lse``."""

    def kernel(tr, te, ln):
        return jnp.sum(lse(_kde_logits(tr, te)) + ln)

    # post-all_gather the result is identical on every shard, but the
    # static replication checker cannot infer that — disable it rather
    # than pay a second collective just to satisfy it
    try:
        fn = shard_map(
            kernel, mesh=mesh,
            in_specs=(P("data", None), P(None, None), P()),
            out_specs=P(), check_vma=False,
        )
    except TypeError:  # older jax spelling
        fn = shard_map(
            kernel, mesh=mesh,
            in_specs=(P("data", None), P(None, None), P()),
            out_specs=P(), check_rep=False,
        )
    return fn(train_white, test_white, lognorm)


def sharded_kde_slogl(mesh: Mesh, train_white, test_white, lognorm):
    """KDE sum-log-likelihood with training points sharded over 'data': a
    numerically stable distributed logsumexp over the training axis.

    Off the CPU the logsumexp takes one all_gather (:func:`_lse_all_gather`);
    on CPU meshes, where collectives are memcpys with no latency to save,
    pmax then psum (:func:`_lse_pmax_psum`). Which form is faster across
    GPUs has not been measured."""
    lse = (_lse_pmax_psum if mesh.devices.flat[0].platform == "cpu"
           else _lse_all_gather)
    return _sharded_kde_slogl(mesh, train_white, test_white, lognorm, lse)
