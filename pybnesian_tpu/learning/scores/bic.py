"""BIC score (reference learning/scores/bic.{hpp,cpp}, 230 LoC).

Dispatches per node type: linear-Gaussian closed form (bic.cpp:12-27),
discrete count form (bic.cpp:66-97), CLG partition (bic.cpp:29-64).
The linear-Gaussian batch path — the hill-climbing hot loop — runs as a
single vmapped device kernel over all candidate families
(:func:`pybnesian_tpu.ops.gaussian.batched_bic`).
"""

from __future__ import annotations

import math

import numpy as np

from ...data import DataFrame
from ...factors.discrete import (
    DiscreteFactorType,
    HostJointCounter,
    create_cardinality_strides,
)
from ...factors.lineargaussian import LinearGaussianCPDType
from ...learning.parameters import mle_lineargaussian
from ...utils import MACHINE_TOL
from .base import Score

__all__ = ["BIC"]

_LOG_2PI = math.log(2 * math.pi)


def _next_pow2(x: int, floor: int = 1) -> int:
    n = max(floor, 1)
    while n < x:
        n *= 2
    return n


def _padded_batched_bic(values, valid, fams):
    """Run :func:`batched_bic` with (F, P) padded to power-of-two buckets so
    the number of distinct compiled shapes stays O(log² F·P) across the whole
    search (every distinct shape costs an XLA compile)."""
    import jax.numpy as jnp

    from ...ops.gaussian import batched_bic

    F = len(fams)
    P = max((len(ps) for _, ps in fams), default=0)
    Fb = _next_pow2(F, 8)
    Pb = _next_pow2(max(P, 1))
    var_idx = np.zeros(Fb, np.int32)
    parent_idx = np.zeros((Fb, Pb), np.int32)
    # values is a device array: read .dtype directly — np.asarray(values)
    # here would fetch the whole data matrix D2H on every scoring batch
    parent_mask = np.zeros((Fb, Pb), values.dtype)
    for f, (vi, ps) in enumerate(fams):
        var_idx[f] = vi
        for j, p in enumerate(ps):
            parent_idx[f, j] = p
            parent_mask[f, j] = 1.0
    scores = batched_bic(
        values,
        valid,
        jnp.asarray(var_idx),
        jnp.asarray(parent_idx),
        jnp.asarray(parent_mask),
    )
    return np.asarray(scores, dtype=np.float64)[:F]


class BIC(Score):
    def __init__(self, df):
        self.df = DataFrame.wrap(df)
        self._device_cache = None
        self._disc_cache = None
        self._host_counter = None
        self._native_cache = None
        self._disc_set = None

    def _discrete_set(self) -> frozenset:
        """Cached discrete-column name set (the DataFrame is immutable):
        per-family dispatch does set lookups instead of per-name
        ``df.is_discrete`` calls — the hc inner loop classifies thousands
        of families per run."""
        if self._disc_set is None:
            self._disc_set = frozenset(self.df.discrete_columns())
        return self._disc_set

    def _native_codes(self):
        """Cached (ncols, n) int32 code block + cards for the native
        discrete scoring core (-1 marks nulls)."""
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

    # ------------------------------------------------------------- dispatch
    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        parents = list(parents)
        if node_type == LinearGaussianCPDType():
            discrete_parents = [
                p for p in parents if self.df.is_discrete(p)
            ]
            continuous_parents = [
                p for p in parents if not self.df.is_discrete(p)
            ]
            if discrete_parents:
                return self._bic_clg(variable, discrete_parents, continuous_parents)
            return self._bic_lineargaussian(variable, parents)
        if node_type == DiscreteFactorType():
            if not all(self.df.is_discrete(p) for p in parents):
                # a discrete child cannot have continuous parents. The
                # reference throws here (bic.cpp:131-135), which would abort
                # a search that proposes the arc (possible in conditional
                # networks whose interface nodes keep UnknownFactorType);
                # scoring it as impossible keeps hc robust without changing
                # any legal result.
                return -math.inf
            return self._bic_discrete(variable, parents)
        raise ValueError(
            f"BIC is not defined for factor type {node_type}."
        )

    # --------------------------------------------------------------- pieces
    def _bic_lineargaussian(self, variable, parents) -> float:
        params = mle_lineargaussian(self.df, variable, parents)
        if params.variance < MACHINE_TOL or math.isinf(params.variance):
            return -math.inf
        n = self.df.valid_rows(variable, *parents)
        k = len(parents)
        loglik = (
            0.5 * (1 + k - n)
            - 0.5 * n * _LOG_2PI
            - 0.5 * n * math.log(params.variance)
        )
        return loglik - math.log(n) * 0.5 * (k + 2)

    def _bic_discrete(self, variable, parents) -> float:
        from . import discrete_native

        if discrete_native.available():
            pos, block, cards = self._native_codes()
            maxp = max(len(parents), 1)
            fam_parents = np.full((1, maxp), -1, np.int32)
            for j, p in enumerate(parents):
                fam_parents[0, j] = pos[p]
            score = discrete_native.bic_batch(
                block, cards, np.array([pos[variable]], np.int32),
                fam_parents,
            )[0]
            if not np.isnan(score):
                return float(score)
        card, strides = create_cardinality_strides(self.df, variable, parents)
        if self._host_counter is None:
            self._host_counter = HostJointCounter(self.df)
        counts = self._host_counter.counts(variable, parents, card, strides)
        k = int(card[0])
        counts2 = counts.reshape(-1, k)
        totals = counts2.sum(axis=1, keepdims=True)
        nz = counts2 > 0
        cnz = counts2[nz]
        ll = float(
            np.sum(cnz * (np.log(cnz) - np.log(np.broadcast_to(totals, counts2.shape)[nz])))
        )
        n = counts.sum()
        num_parent_configs = counts2.shape[0]
        return ll - math.log(n) * 0.5 * (k - 1) * num_parent_configs

    def _bic_clg(self, variable, discrete_parents, continuous_parents) -> float:
        """Per-discrete-configuration linear regressions (bic.cpp:29-64)."""
        card, strides = create_cardinality_strides(
            self.df, discrete_parents[0], discrete_parents[1:]
        )
        from ...factors.discrete import flat_indices

        config_idx = flat_indices(self.df, discrete_parents, strides)
        num_configs = int(np.prod(card))
        loglik = 0.0
        kc = len(continuous_parents)
        all_idx = np.arange(self.df.num_rows)
        for c in range(num_configs):
            rows = all_idx[config_idx == c]
            if len(rows) == 0:
                continue
            sub = self.df.take(rows)
            params = mle_lineargaussian(sub, variable, continuous_parents)
            if params.variance < MACHINE_TOL or math.isinf(params.variance):
                return -math.inf
            nv = sub.valid_rows(variable, *continuous_parents)
            loglik += (
                0.5 * (1 + kc - nv)
                - 0.5 * nv * _LOG_2PI
                - 0.5 * nv * math.log(params.variance)
            )
        n = self.df.valid_rows(variable, *discrete_parents, *continuous_parents)
        return loglik - math.log(n) * 0.5 * num_configs * (kc + 2)

    # --------------------------------------------------- batched (device)
    def _device_data(self):
        if self._device_cache is None:
            cols = self.df.continuous_columns()
            values, valid = self.df.device_matrix(cols)
            self._device_cache = (
                {c: i for i, c in enumerate(cols)},
                values,
                valid,
            )
        return self._device_cache

    def local_score_batch(self, model, families) -> np.ndarray:
        """One device call for all linear-Gaussian families; host fallback for
        discrete/CLG families."""
        import jax.numpy as jnp

        from ...ops.gaussian import batched_bic

        homog_nt = (
            model.type().default_node_type()
            if model.type().is_homogeneous()
            else None
        )
        norm = []
        for fam in families:
            if len(fam) == 3:
                v, ps, nt = fam
                if nt is None:
                    nt = homog_nt or self._node_type(model, v)
            else:
                v, ps = fam
                nt = homog_nt or self._node_type(model, v)
            norm.append((v, list(ps), nt))

        out = np.empty(len(norm))
        lg_idx = []
        disc_idx = []
        lg_t = LinearGaussianCPDType()
        dc_t = DiscreteFactorType()
        disc = self._discrete_set()
        for i, (v, ps, nt) in enumerate(norm):
            if nt == lg_t and v not in disc and not any(
                p in disc for p in ps
            ):
                lg_idx.append(i)
            elif nt == dc_t and v in disc and all(p in disc for p in ps):
                disc_idx.append(i)
            else:
                out[i] = self.local_score_node_type(model, nt, v, ps)

        if disc_idx:
            out[np.array(disc_idx)] = self._batched_discrete(
                [(norm[i][0], norm[i][1]) for i in disc_idx]
            )
        if lg_idx:
            pos, values, valid = self._device_data()
            fams = [(pos[norm[i][0]], [pos[p] for p in norm[i][1]]) for i in lg_idx]
            scores = _padded_batched_bic(values, valid, fams)
            out[np.array(lg_idx)] = scores
        return out

    def _batched_discrete(self, fams) -> np.ndarray:
        """Discrete families via one scatter-count device call; small
        batches stay on host, where stride-counting a few million items
        beats a device dispatch (adaptive dispatch, same idea as BLAS
        small-matrix fast paths)."""
        # crossover: the native counting core runs ~0.5 ns/row/column; the
        # 10M row-item threshold was set against an earlier accelerator's
        # dispatch cost and has not been measured on a GPU
        if len(fams) * self.df.num_rows < 10_000_000:
            from . import discrete_native

            if discrete_native.available():
                pos, block, cards = self._native_codes()
                F = len(fams)
                scores = np.empty(F)
                # hc column updates score many (t, P ∪ {s}) families that
                # share (t, P): group them so ONE shared-base pass counts
                # every candidate (dc_bic_addcand) instead of re-reading
                # the base columns per family. Only pays off once the code
                # block outgrows cache (memory-bound regime); for resident
                # blocks the specialized per-family loops are op-bound and
                # faster.
                groups: dict = {}
                if self.df.num_rows >= 65536:
                    for i, (v, ps) in enumerate(fams):
                        if ps:
                            groups.setdefault(
                                (v, tuple(ps[:-1])), []
                            ).append(i)
                rest = []
                done = np.zeros(F, bool)
                for (v, basep), idxs in groups.items():
                    if len(idxs) < 4:
                        continue
                    base_idx = np.fromiter(
                        (pos[p] for p in basep), np.int32, len(basep)
                    )
                    cand_idx = np.fromiter(
                        (pos[fams[i][1][-1]] for i in idxs), np.int32,
                        len(idxs),
                    )
                    vals = discrete_native.bic_addcand(
                        block, cards, pos[v], base_idx, cand_idx
                    )
                    scores[idxs] = vals
                    done[idxs] = True
                rest = [i for i in range(F) if not done[i]]
                if rest:
                    maxp = max(
                        (len(fams[i][1]) for i in rest), default=0
                    )
                    maxp = max(maxp, 1)
                    fam_var = np.array(
                        [pos[fams[i][0]] for i in rest], np.int32
                    )
                    fam_parents = np.full((len(rest), maxp), -1, np.int32)
                    for f, i in enumerate(rest):
                        for j, p in enumerate(fams[i][1]):
                            fam_parents[f, j] = pos[p]
                    scores[rest] = discrete_native.bic_batch(
                        block, cards, fam_var, fam_parents
                    )
                bad = np.isnan(scores)
                if bad.any():
                    for i in np.nonzero(bad)[0]:
                        scores[i] = self._bic_discrete(*fams[i])
                return scores
            return np.array([self._bic_discrete(v, ps) for v, ps in fams])
        import jax.numpy as jnp

        from ...ops.discrete import batched_bic_discrete

        if self._disc_cache is None:
            cols = self.df.discrete_columns()
            self._disc_cache = (
                {c: i for i, c in enumerate(cols)},
                self.df.device_codes(cols),
                jnp.asarray(
                    np.array([self.df.cardinality(c) for c in cols], np.int32)
                ),
                np.array([self.df.cardinality(c) for c in cols]),
            )
        pos, codes, cards_dev, cards_np = self._disc_cache
        F = len(fams)
        Fb = _next_pow2(F, 8)
        P = max((len(ps) for _, ps in fams), default=0)
        Pb = _next_pow2(max(P, 1))
        var_idx = np.zeros(Fb, np.int32)
        parent_idx = np.zeros((Fb, Pb), np.int32)
        parent_mask = np.zeros((Fb, Pb), np.float32)
        max_cells = 1
        max_pconfigs = 1
        for f, (v, ps) in enumerate(fams):
            var_idx[f] = pos[v]
            pconf = 1
            for j, p in enumerate(ps):
                parent_idx[f, j] = pos[p]
                parent_mask[f, j] = 1.0
                pconf *= cards_np[pos[p]]
            max_cells = max(max_cells, cards_np[pos[v]] * pconf)
            max_pconfigs = max(max_pconfigs, pconf)
        scores = batched_bic_discrete(
            codes,
            cards_dev,
            jnp.asarray(var_idx),
            jnp.asarray(parent_idx),
            jnp.asarray(parent_mask),
            max_cells=_next_pow2(int(max_cells)),
            max_pconfigs=_next_pow2(int(max_pconfigs)),
        )
        return np.asarray(scores, np.float64)[:F]

    def ToString(self) -> str:
        return "BIC"
