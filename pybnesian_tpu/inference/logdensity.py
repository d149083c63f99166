"""Joint log-densities over Bayesian-network CPD parameters.

Net-new subsystem (the reference explicitly defers inference,
README.md:110-113): turns a fitted/unfitted BN structure + data into a pure,
jittable ``logdensity(params)`` over a flat parameter vector, ready for
HMC/NUTS/ADVI/SMC. Supported CPD families:

- LinearGaussian nodes: params (beta, log_variance) per node; Gaussian prior
  on beta, log-variance flat-normal prior.
- Discrete nodes: unconstrained logits per CPT row with a Dirichlet prior via
  the softmax reparameterisation.

The density evaluates as masked batched linear algebra on device — the same
design-matrix layout as :mod:`pybnesian_tpu.ops.gaussian`.
"""

from __future__ import annotations

import math

import numpy as np

from ..data import DataFrame
from ..factors.discrete import DiscreteFactorType
from ..factors.lineargaussian import LinearGaussianCPDType

__all__ = ["make_logdensity", "ParamLayout"]

_LOG_2PI = math.log(2 * math.pi)


class ParamLayout:
    """Mapping node → slice of the flat parameter vector."""

    def __init__(self):
        self.slices: dict[str, tuple[int, int, str]] = {}
        self.size = 0

    def add(self, node: str, n: int, kind: str):
        self.slices[node] = (self.size, self.size + n, kind)
        self.size += n

    def unpack(self, node: str, theta):
        lo, hi, _ = self.slices[node]
        return theta[lo:hi]


def make_logdensity(model, df, beta_prior_scale: float = 10.0,
                    logvar_prior_scale: float = 5.0,
                    dirichlet_alpha: float = 1.0, dtype=None):
    """(logdensity_fn, layout, init_params) for the given model + data.

    logdensity_fn: flat jnp vector -> scalar log p(data | params) + log prior.
    """
    import jax
    import jax.numpy as jnp

    df = DataFrame.wrap(df)
    layout = ParamLayout()
    pieces = []  # list of closures theta -> scalar
    init = []

    cont_cols = df.continuous_columns()
    if dtype is None:
        dtype = np.float32
    values, valid = df.device_matrix(cont_cols, dtype=dtype)
    pos = {c: i for i, c in enumerate(cont_cols)}

    for node in model.nodes():
        node_type = model.underlying_node_type(df, node)
        parents = model.parents(node)
        if node_type == LinearGaussianCPDType() and any(
            df.is_discrete(p) for p in parents
        ):
            # CLG node: one (beta, log-variance) block per discrete parent
            # configuration (the reference's CLinearGaussianCPD partition)
            from ..factors.discrete import (
                create_cardinality_strides,
                flat_indices,
            )

            disc = [p for p in parents if df.is_discrete(p)]
            cont = [p for p in parents if not df.is_discrete(p)]
            card, strides = create_cardinality_strides(df, disc[0], disc[1:])
            n_configs = int(np.prod(card))
            cfg = flat_indices(df, disc, strides)
            k = len(cont)
            block = k + 2
            layout.add(node, n_configs * block, "clg")
            y = values[:, pos[node]]
            X = (
                values[:, [pos[p] for p in cont]]
                if cont
                else jnp.zeros((df.num_rows, 0), values.dtype)
            )
            w_base = valid[:, pos[node]]
            for p in cont:
                w_base = w_base * valid[:, pos[p]]
            cfg_onehot = jnp.asarray(
                np.stack(
                    [(cfg == c).astype(dtype) for c in range(n_configs)]
                )
            )  # (n_configs, n)
            lo, hi, _ = layout.slices[node]

            def clg_piece(theta, y=y, X=X, w_base=w_base,
                          cfg_onehot=cfg_onehot, lo=lo, k=k, block=block,
                          n_configs=n_configs):
                params = theta[lo: lo + n_configs * block].reshape(
                    n_configs, block
                )

                def one_config(p, mask):
                    beta = p[: k + 1]
                    logvar = p[k + 1]
                    mean = beta[0] + jnp.matmul(
                        X, beta[1:], precision=jax.lax.Precision.HIGHEST
                    )
                    ll = (
                        -0.5 * jnp.square(y - mean) * jnp.exp(-logvar)
                        - 0.5 * logvar
                        - 0.5 * _LOG_2PI
                    )
                    prior = -0.5 * jnp.sum(
                        jnp.square(beta) / beta_prior_scale**2
                    ) - 0.5 * jnp.square(logvar) / logvar_prior_scale**2
                    return jnp.sum(ll * w_base * mask) + prior

                return jnp.sum(jax.vmap(one_config)(params, cfg_onehot))

            pieces.append(clg_piece)
            from ..learning.parameters import mle_lineargaussian

            init_block = np.zeros((n_configs, block))
            all_rows = np.arange(df.num_rows)
            for c in range(n_configs):
                rows = all_rows[cfg == c]
                if len(rows) > k + 2:
                    params = mle_lineargaussian(df.take(rows), node, cont)
                    var0 = params.variance
                    if not np.isfinite(var0) or var0 <= 0:
                        var0 = 1.0
                    init_block[c] = np.concatenate(
                        [np.nan_to_num(params.beta), [math.log(var0)]]
                    )
            init.append(init_block.reshape(-1))
        elif node_type == LinearGaussianCPDType() and not any(
            df.is_discrete(p) for p in parents
        ):
            k = len(parents)
            layout.add(node, k + 2, "lg")
            y = values[:, pos[node]]
            X = (
                values[:, [pos[p] for p in parents]]
                if parents
                else jnp.zeros((df.num_rows, 0), values.dtype)
            )
            w = valid[:, pos[node]]
            for p in parents:
                w = w * valid[:, pos[p]]
            lo, hi, _ = layout.slices[node]

            def lg_piece(theta, y=y, X=X, w=w, lo=lo, hi=hi, k=k):
                beta = theta[lo: lo + k + 1]
                logvar = theta[hi - 1]
                mean = beta[0] + jnp.matmul(
                    X, beta[1:], precision=jax.lax.Precision.HIGHEST
                )
                ll = (
                    -0.5 * jnp.square(y - mean) * jnp.exp(-logvar)
                    - 0.5 * logvar
                    - 0.5 * _LOG_2PI
                )
                prior = -0.5 * jnp.sum(
                    jnp.square(beta) / beta_prior_scale**2
                ) - 0.5 * jnp.square(logvar) / logvar_prior_scale**2
                return jnp.sum(ll * w) + prior

            pieces.append(lg_piece)
            from ..learning.parameters import mle_lineargaussian

            params = mle_lineargaussian(df, node, parents)
            var0 = params.variance
            if not np.isfinite(var0) or var0 <= 0:
                var0 = 1.0
            init.append(
                np.concatenate(
                    [np.nan_to_num(params.beta), [math.log(var0)]]
                )
            )
        elif node_type == DiscreteFactorType():
            from ..factors.discrete import create_cardinality_strides, flat_indices

            card, strides = create_cardinality_strides(df, node, [
                p for p in parents
            ])
            kcat = int(card[0])
            n_configs = int(np.prod(card[1:])) if len(card) > 1 else 1
            n_par = kcat * n_configs
            layout.add(node, n_par, "discrete")
            idx = flat_indices(df, [node, *parents], strides)
            counts = np.bincount(
                idx[idx >= 0], minlength=n_par
            ).astype(np.float64).reshape(n_configs, kcat)
            counts_dev = jnp.asarray(counts.astype(dtype))
            lo, hi, _ = layout.slices[node]

            def disc_piece(theta, counts=counts_dev, lo=lo, hi=hi,
                           n_configs=n_configs, kcat=kcat):
                logits = theta[lo:hi].reshape(n_configs, kcat)
                logp = logits - jnp.log(
                    jnp.sum(jnp.exp(logits - logits.max(1, keepdims=True)), 1,
                            keepdims=True)
                ) - logits.max(1, keepdims=True)
                ll = jnp.sum(counts * logp)
                prior = jnp.sum((dirichlet_alpha - 1.0) * logp) - 0.5 * jnp.sum(
                    jnp.square(logits)
                ) * 1e-2
                return ll + prior

            pieces.append(disc_piece)
            init.append(np.zeros(n_par))
        else:
            raise ValueError(
                f"make_logdensity does not support node type {node_type} "
                f"for node {node}"
            )

    init_flat = jnp.asarray(np.concatenate(init).astype(dtype)) if init else (
        jnp.zeros(0, dtype)
    )

    def logdensity(theta):
        total = jnp.asarray(0.0, theta.dtype)
        for piece in pieces:
            total = total + piece(theta)
        return total

    return logdensity, layout, init_flat
