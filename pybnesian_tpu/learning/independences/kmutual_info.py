"""CMIknn: k-NN (conditional) mutual information test with local permutation
p-values (Runge 2018).

Rebuild of reference learning/independences/continuous/mutual_information.
{hpp,cpp}: rank-transform data once, Kraskov-style CMI estimator, p-value =
fraction of (locally) shuffled estimates ≥ the observed one. Batched: all
``samples`` permutations evaluate in one jitted device loop over cached
pairwise distances (:mod:`pybnesian_tpu.ops.knn`) instead of the reference's
per-permutation kd-tree rebuilds.
"""

from __future__ import annotations

import numpy as np

from ...data import DataFrame
from .base import DynamicIndependenceTest, IndependenceTest

__all__ = ["KMutualInformation", "DynamicKMutualInformation", "rank_data"]


def rank_data(mat: np.ndarray) -> np.ndarray:
    """Per-column 0-based ordinal ranks (reference
    mutual_information.hpp:16-54)."""
    out = np.empty_like(mat, dtype=np.float64)
    for j in range(mat.shape[1]):
        order = np.argsort(mat[:, j], kind="stable")
        out[order, j] = np.arange(len(mat))
    return out


class KMutualInformation(IndependenceTest):
    def __init__(self, df, k: int, seed: int | None = None,
                 shuffle_neighbors: int = 5, samples: int = 1000):
        self.df = DataFrame.wrap(df)
        self.k = int(k)
        self.seed = seed if seed is not None else 0
        self.shuffle_neighbors = int(shuffle_neighbors)
        self.samples = int(samples)
        cols = self.df.column_names()
        mat = self.df.to_numpy(cols, drop_null=False, dtype=np.float64)
        # the reference ranks raw_values with no null handling
        # (mutual_information.hpp:29-38) — undefined on null data. Here null
        # rows are DROPPED before ranking (listwise): np.argsort would
        # otherwise rank NaNs as extreme values and silently bias the CMI
        # estimate.
        complete = ~np.isnan(mat).any(axis=1)
        if not complete.all():
            mat = mat[complete]
        # the conditional-pvalue local shuffle draws shuffle_neighbors
        # OTHER rows per row, so it needs strictly more rows than either
        # bound
        min_rows = max(self.k, self.shuffle_neighbors)
        if len(mat) <= min_rows:
            raise ValueError(
                "KMutualInformation requires more complete rows than "
                f"max(k, shuffle_neighbors) (have {len(mat)}, k={self.k}, "
                f"shuffle_neighbors={self.shuffle_neighbors})."
            )
        self._ranked = rank_data(mat)
        self._pos = {c: i for i, c in enumerate(cols)}

    def variable_names(self) -> list[str]:
        return self.df.column_names()

    # ------------------------------------------------------------------- mi
    def mi(self, x: str, y: str, *z: str) -> float:
        z = list(z[0]) if len(z) == 1 and not isinstance(z[0], str) else list(z)
        import jax.numpy as jnp

        from ...ops.knn import cmi_knn_conditional, cmi_knn_pair

        xr = jnp.asarray(self._ranked[:, self._pos[x]])
        yr = jnp.asarray(self._ranked[:, self._pos[y]])
        if not z:
            return float(cmi_knn_pair(xr, yr, self.k))
        dz = jnp.asarray(self._z_distances(z))
        return float(cmi_knn_conditional(xr, yr, dz, self.k))

    def _z_distances(self, z) -> np.ndarray:
        zr = self._ranked[:, [self._pos[e] for e in z]]
        return np.max(np.abs(zr[:, None, :] - zr[None, :, :]), axis=2)

    # ------------------------------------------------------------- shuffles
    def _marginal_perms(self, xr: np.ndarray, rng) -> np.ndarray:
        return np.stack([rng.permutation(xr) for _ in range(self.samples)])

    def _cond_neighbors(self, dz: np.ndarray) -> np.ndarray:
        """Per-row ``shuffle_neighbors`` nearest z-neighbours (self
        excluded). An O(n²) argpartition narrows each row to a small
        candidate set before ordering it — the previous full stable
        argsort was O(n² log n) and dominated conditional p-values. Rank
        ties make the k-smallest SET implementation-defined either way;
        candidates are ordered (distance, index) so the draw stays
        deterministic."""
        n = len(dz)
        m = self.shuffle_neighbors
        kk = min(m + 1, n - 1)  # +1: self is always among the smallest
        part = np.argpartition(dz, kk, axis=1)[:, : kk + 1]
        pdist = np.take_along_axis(dz, part, axis=1)
        # stable order within candidates by (distance, index)
        sub = np.lexsort((part, pdist), axis=1)
        ordered = np.take_along_axis(part, sub, axis=1)
        neighbors = np.empty((n, m), dtype=np.int64)
        for i in range(n):
            row = ordered[i]
            row = row[row != i][:m]
            neighbors[i] = row
        return neighbors

    def _local_shuffle_all(self, xr: np.ndarray, neighbors: np.ndarray,
                           rng) -> np.ndarray:
        """All ``samples`` locally-shuffled draws. Native batch when the
        compiled core is available (~50x the Python loop; deterministic
        per-seed stream shared by serial and batched p-values), Python
        loop otherwise."""
        from ...models.base import _lgfast_mod

        mod = _lgfast_mod()
        if mod is not None and neighbors.shape[1] > 0:
            out = np.empty((self.samples, len(xr)))
            mod.lgf_local_shuffle(
                np.ascontiguousarray(xr),
                np.ascontiguousarray(neighbors, np.int32),
                self.samples,
                int(self.seed),
                out,
            )
            return out
        return np.stack(
            [
                self._local_shuffle(xr, neighbors, rng)
                for _ in range(self.samples)
            ]
        )

    # -------------------------------------------------------------- pvalue
    def pvalue(self, x: str, y: str, *z: str) -> float:
        z = list(z[0]) if len(z) == 1 and not isinstance(z[0], str) else list(z)
        import jax.numpy as jnp

        from ...ops.knn import cmi_knn_conditional_batch, cmi_knn_pair_batch

        rng = np.random.default_rng(self.seed)
        xr = self._ranked[:, self._pos[x]]
        yr = jnp.asarray(self._ranked[:, self._pos[y]])
        n = len(xr)

        if not z:
            original = self.mi(x, y)
            perms = np.stack(
                [rng.permutation(xr) for _ in range(self.samples)]
            )
            shuffled = np.asarray(
                cmi_knn_pair_batch(jnp.asarray(perms), yr, self.k)
            )
            return float(np.mean(shuffled >= original))

        original = self.mi(x, y, *z)
        dz = self._z_distances(z)
        # nearest z-neighbours for the local shuffle (excluding self)
        neighbors = self._cond_neighbors(dz)
        perms = self._local_shuffle_all(xr, neighbors, rng)
        shuffled = np.asarray(
            cmi_knn_conditional_batch(
                jnp.asarray(perms), yr, jnp.asarray(dz), self.k
            )
        )
        return float(np.mean(shuffled >= original))

    def _local_shuffle(self, x_rank: np.ndarray, neighbors: np.ndarray,
                       rng) -> np.ndarray:
        """Permute x within z-neighbourhoods, then re-rank
        (reference shuffle_dataframe, mutual_information.hpp:119-160)."""
        n = len(x_rank)
        shuffled = np.empty(n)
        used = np.zeros(n, dtype=bool)
        order = rng.permutation(n)
        m = neighbors.shape[1]
        for idx in order:
            cand = neighbors[idx][rng.permutation(m)]
            pick = cand[-1]
            for c in cand:
                if not used[c]:
                    pick = c
                    break
            if used[pick]:
                shuffled[idx] = x_rank[pick] + rng.uniform(-0.4, 0.4)
            else:
                shuffled[idx] = x_rank[pick]
            used[pick] = True
        # re-rank to integers
        out = np.empty(n)
        order2 = np.argsort(shuffled, kind="stable")
        out[order2] = np.arange(n)
        return out


    # -------------------------------------------------------- batched sweep
    def pvalue_batch(self, triples) -> np.ndarray:
        """Cross-test batching: every test still evaluates its own
        ``samples`` permutations, but T tests share ONE device launch per
        chunk (each extra launch costs a dispatch round trip; reference
        pc.cpp applies its serial loop uniformly). Per-test streams match
        the serial path (same per-test rng seeding), so the estimates are
        the same Monte-Carlo values."""
        import jax.numpy as jnp

        from ...ops.knn import (
            cmi_knn_conditional_tests,
            cmi_knn_pair_tests,
        )

        triples = [(x, y, tuple(zs)) for (x, y, zs) in triples]
        if len(triples) < 2:
            return super().pvalue_batch(triples)
        out = np.empty(len(triples))
        marg = [i for i, t in enumerate(triples) if not t[2]]
        cond = [i for i, t in enumerate(triples) if t[2]]
        S = self.samples + 1  # row 0 = unshuffled (the observed statistic)

        def run_chunk(idxs, conditional):
            T = len(idxs)
            n = self._ranked.shape[0]
            xs_t = np.empty((T, S, n))
            ys_t = np.empty((T, n))
            dz_t = np.empty((T, n, n)) if conditional else None
            for j, i in enumerate(idxs):
                x, y, zs = triples[i]
                rng = np.random.default_rng(self.seed)
                xr = self._ranked[:, self._pos[x]]
                ys_t[j] = self._ranked[:, self._pos[y]]
                xs_t[j, 0] = xr
                if conditional:
                    dz = self._z_distances(list(zs))
                    dz_t[j] = dz
                    xs_t[j, 1:] = self._local_shuffle_all(
                        xr, self._cond_neighbors(dz), rng
                    )
                else:
                    xs_t[j, 1:] = self._marginal_perms(xr, rng)
            if conditional:
                vals = np.asarray(
                    cmi_knn_conditional_tests(
                        jnp.asarray(xs_t), jnp.asarray(ys_t),
                        jnp.asarray(dz_t), self.k,
                    )
                )
            else:
                vals = np.asarray(
                    cmi_knn_pair_tests(
                        jnp.asarray(xs_t), jnp.asarray(ys_t), self.k
                    )
                )
            for j, i in enumerate(idxs):
                out[i] = float(np.mean(vals[j, 1:] >= vals[j, 0]))

        # fixed chunk caps: each (T, S, n) shape compiles once per cap
        for idxs, conditional, cap in ((marg, False, 8), (cond, True, 2)):
            for c0 in range(0, len(idxs), cap):
                run_chunk(idxs[c0 : c0 + cap], conditional)
        return out


class DynamicKMutualInformation(DynamicIndependenceTest):
    test_cls = KMutualInformation
