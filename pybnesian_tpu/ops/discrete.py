"""Device kernels for discrete (multinomial) factors and scores.

Batched replacement for the reference's stride-based CPT counting
(factors/discrete/discrete_indices.{hpp,cpp}) and the serial per-family
BDe/BIC count loops (learning/scores/bde.cpp, bic.cpp:66-97): a batch of
candidate families is counted with one scatter-add per family (vmapped), and
the Dirichlet/BIC closed forms evaluate with masked lgamma sums. Ragged
cardinalities are padded to ``max_cells`` / ``max_pconfigs`` buckets.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _family_counts(codes, cards, vi, pi, pm, max_cells, max_pconfigs):
    """(cell_counts, pconfig_counts, num_cells, num_pconfigs, vcard, n_valid)
    for one family. Invalid rows (nulls) go to an overflow bin."""
    pmb = pm.astype(bool)
    vcode = codes[:, vi]
    vcard = cards[vi]
    pcodes = jnp.where(pmb[None, :], codes[:, pi], 0)
    pcard = jnp.where(pmb, cards[pi], 1)
    valid = (vcode >= 0) & jnp.all((codes[:, pi] >= 0) | ~pmb[None, :], axis=1)
    # parent strides: stride_j = prod(pcard[:j])
    pstrides = jnp.concatenate(
        [jnp.ones(1, pcard.dtype), jnp.cumprod(pcard)[:-1]]
    )
    pconfig = jnp.sum(pcodes * pstrides[None, :], axis=1)
    num_pconfigs = jnp.prod(pcard)
    cell = vcode + vcard * pconfig
    cell = jnp.where(valid, cell, max_cells)
    # Histogram via comparison-reduction rather than scatter-add: an
    # (C, N) equality + row-reduce is one fused reduction with no write
    # conflicts (C and N are both static here).
    # default float dtype: f64 under jax_enable_x64 (tests), f32 otherwise
    one = jnp.ones((), jnp.zeros(0).dtype)
    counts = jnp.sum(
        (jnp.arange(max_cells)[:, None] == cell[None, :]) * one, axis=1
    )
    pconfig_safe = jnp.where(valid, pconfig, max_pconfigs)
    pcounts = jnp.sum(
        (jnp.arange(max_pconfigs)[:, None] == pconfig_safe[None, :]) * one,
        axis=1,
    )
    return counts, pcounts, vcard * num_pconfigs, num_pconfigs, vcard, jnp.sum(valid)


@partial(jax.jit, static_argnames=("max_cells", "max_pconfigs"))
def batched_bde(codes, cards, var_idx, parent_idx, parent_mask, iss,
                max_cells, max_pconfigs):
    """BDe local scores for F families in one call
    (formulas: reference learning/scores/bde.cpp:5-48)."""

    def one(vi, pi, pm):
        counts, pcounts, num_cells, num_pconfigs, vcard, _ = _family_counts(
            codes, cards, vi, pi, pm, max_cells, max_pconfigs
        )
        alpha = iss / num_cells
        cell_mask = jnp.arange(max_cells) < num_cells
        res = jnp.sum(
            jnp.where(
                cell_mask,
                jax.lax.lgamma(counts + alpha) - jax.lax.lgamma(alpha),
                0.0,
            )
        )
        sum_alpha = alpha * vcard
        pconf_mask = jnp.arange(max_pconfigs) < num_pconfigs
        res += jnp.sum(
            jnp.where(
                pconf_mask,
                jax.lax.lgamma(sum_alpha)
                - jax.lax.lgamma(sum_alpha + pcounts),
                0.0,
            )
        )
        return res

    return jax.vmap(one)(var_idx, parent_idx, parent_mask)


@partial(jax.jit, static_argnames=("max_cells", "max_pconfigs"))
def batched_bic_discrete(codes, cards, var_idx, parent_idx, parent_mask,
                         max_cells, max_pconfigs):
    """Discrete BIC local scores for F families in one call
    (formula: reference learning/scores/bic.cpp:66-97)."""

    def one(vi, pi, pm):
        counts, pcounts, num_cells, num_pconfigs, vcard, n = _family_counts(
            codes, cards, vi, pi, pm, max_cells, max_pconfigs
        )
        cell_mask = (jnp.arange(max_cells) < num_cells) & (counts > 0)
        ll = jnp.sum(
            jnp.where(cell_mask, counts * jnp.log(jnp.maximum(counts, 1.0)), 0.0)
        )
        pconf_mask = (jnp.arange(max_pconfigs) < num_pconfigs) & (pcounts > 0)
        ll -= jnp.sum(
            jnp.where(
                pconf_mask, pcounts * jnp.log(jnp.maximum(pcounts, 1.0)), 0.0
            )
        )
        penalty = (
            jnp.log(n.astype(counts.dtype))
            * 0.5
            * (vcard - 1.0)
            * num_pconfigs
        )
        return ll - penalty

    return jax.vmap(one)(var_idx, parent_idx, parent_mask)
