"""BDe: Bayesian Dirichlet equivalent score.

Rebuild of reference learning/scores/bde.{hpp,cpp} (~230 LoC): the iss prior
spread uniformly over joint configurations. The batch path counts and scores
all candidate families in one device call
(:func:`pybnesian_tpu.ops.discrete.batched_bde`).
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln

from ...data import DataFrame
from ...factors.discrete import (
    DiscreteFactorType,
    HostJointCounter,
    create_cardinality_strides,
)
from .base import Score

__all__ = ["BDe"]


def _next_pow2(x: int, floor: int = 1) -> int:
    n = max(floor, 1)
    while n < x:
        n *= 2
    return n


class BDe(Score):
    def __init__(self, df, iss: float = 1.0):
        self.df = DataFrame.wrap(df)
        self.iss = float(iss)
        self._codes_cache = None
        self._host_counter = None
        self._native_cache = None

    def _native_codes(self):
        """Cached (ncols, n) int32 code block + cards for the native
        scoring core (-1 marks nulls) — same layout as BIC's."""
        if self._native_cache is None:
            cols = self.df.discrete_columns()
            block = np.ascontiguousarray(
                np.stack([
                    self.df.codes(c).astype(np.int32) for c in cols
                ])
                if cols else np.zeros((0, self.df.num_rows), np.int32)
            )
            cards = np.array(
                [self.df.cardinality(c) for c in cols], np.int64
            )
            self._native_cache = (
                {c: i for i, c in enumerate(cols)}, block, cards
            )
        return self._native_cache

    def data(self):
        return self.df

    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        if node_type != DiscreteFactorType():
            raise ValueError(
                f'Node type "{node_type}" not valid for score BDe'
            )
        parents = list(parents)
        if not all(self.df.is_discrete(p) for p in parents):
            # mirror BIC: impossible family (discrete child, continuous
            # parent) scores -inf instead of aborting the search
            import math

            return -math.inf
        card, strides = create_cardinality_strides(self.df, variable, parents)
        if self._host_counter is None:
            self._host_counter = HostJointCounter(self.df)
        counts = self._host_counter.counts(variable, parents, card, strides)
        k = int(card[0])
        cardinality_prod = int(np.prod(card))
        alpha = self.iss / cardinality_prod
        counts2 = counts.reshape(-1, k)
        res = float(
            np.sum(gammaln(counts2 + alpha)) - cardinality_prod * gammaln(alpha)
        )
        sums = counts2.sum(axis=1)
        sum_alpha = alpha * k
        res += float(np.sum(gammaln(sum_alpha) - gammaln(sum_alpha + sums)))
        return res

    # --------------------------------------------------- batched (device)
    def _device_codes(self):
        if self._codes_cache is None:
            import jax.numpy as jnp

            cols = self.df.discrete_columns()
            codes = self.df.device_codes(cols)
            cards = jnp.asarray(
                np.array([self.df.cardinality(c) for c in cols], np.int32)
            )
            self._codes_cache = (
                {c: i for i, c in enumerate(cols)},
                codes,
                cards,
                np.array([self.df.cardinality(c) for c in cols]),
            )
        return self._codes_cache

    def local_score_batch(self, model, families) -> np.ndarray:
        import jax.numpy as jnp

        from ...ops.discrete import batched_bde

        norm = []
        for fam in families:
            if len(fam) == 3:
                v, ps, nt = fam
                if nt is None:
                    nt = self._node_type(model, v)
            else:
                v, ps = fam
                nt = self._node_type(model, v)
            norm.append((v, list(ps), nt))
        out = np.empty(len(norm))
        disc_idx = [
            i
            for i, (v, ps, nt) in enumerate(norm)
            if nt == DiscreteFactorType()
            and self.df.is_discrete(v)
            and all(self.df.is_discrete(p) for p in ps)
        ]
        disc_set = set(disc_idx)
        for i, (v, ps, nt) in enumerate(norm):
            if i not in disc_set:
                out[i] = self.local_score_node_type(model, nt, v, ps)
        if disc_idx and len(disc_idx) * self.df.num_rows < 10_000_000:
            # latency-dominated batch: the native counting tier beats a
            # device trip (adaptive dispatch, same crossover as BIC's)
            from . import discrete_native

            if discrete_native.available():
                pos, block, cards = self._native_codes()
                F = len(disc_idx)
                maxp = max(
                    (len(norm[i][1]) for i in disc_idx), default=0
                )
                maxp = max(maxp, 1)
                fam_var = np.array(
                    [pos[norm[i][0]] for i in disc_idx], np.int32
                )
                fam_parents = np.full((F, maxp), -1, np.int32)
                for f, i in enumerate(disc_idx):
                    for j, p in enumerate(norm[i][1]):
                        fam_parents[f, j] = pos[p]
                scores = discrete_native.bde_batch(
                    block, cards, fam_var, fam_parents, self.iss
                )
                bad = np.isnan(scores)
                for f, i in enumerate(disc_idx):
                    out[i] = (
                        self.local_score_node_type(model, norm[i][2],
                                                   norm[i][0], norm[i][1])
                        if bad[f]
                        else scores[f]
                    )
            else:
                for i in disc_idx:
                    v, ps, nt = norm[i]
                    out[i] = self.local_score_node_type(model, nt, v, ps)
        elif disc_idx:
            pos, codes, cards_dev, cards_np = self._device_codes()
            F = len(disc_idx)
            Fb = _next_pow2(F, 8)
            P = max((len(norm[i][1]) for i in disc_idx), default=0)
            Pb = _next_pow2(max(P, 1))
            var_idx = np.zeros(Fb, np.int32)
            parent_idx = np.zeros((Fb, Pb), np.int32)
            parent_mask = np.zeros((Fb, Pb), np.float32)
            max_cells = 1
            max_pconfigs = 1
            for f, i in enumerate(disc_idx):
                v, ps, _ = norm[i]
                var_idx[f] = pos[v]
                cells = cards_np[pos[v]]
                pconf = 1
                for j, p in enumerate(ps):
                    parent_idx[f, j] = pos[p]
                    parent_mask[f, j] = 1.0
                    pconf *= cards_np[pos[p]]
                max_cells = max(max_cells, cells * pconf)
                max_pconfigs = max(max_pconfigs, pconf)
            scores = batched_bde(
                codes,
                cards_dev,
                jnp.asarray(var_idx),
                jnp.asarray(parent_idx),
                jnp.asarray(parent_mask),
                self.iss,
                max_cells=_next_pow2(max_cells),
                max_pconfigs=_next_pow2(max_pconfigs),
            )
            out[np.array(disc_idx)] = np.asarray(scores, np.float64)[:F]
        return out

    def ToString(self) -> str:
        return "BDe"
