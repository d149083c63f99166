"""Likelihood-based scores: CVLikelihood, HoldoutLikelihood,
ValidatedLikelihood.

Rebuild of reference learning/scores/cv_likelihood.{hpp,cpp},
holdout_likelihood.{hpp,cpp}, validated_likelihood.hpp:12-80.

This is the hot path for KDE-network structure learning (SURVEY.md §3.1) and
the BASELINE north-star metric. Batched restructuring: instead of the
reference's serial per-(family, fold) factor fit+slogl, the linear-Gaussian
path evaluates all families × folds in one vmapped kernel
(:func:`pybnesian_tpu.ops.gaussian.batched_lg_cv_loglik`) and the CKDE path
batches all folds of a family into one pairwise-logsumexp launch
(:func:`pybnesian_tpu.ops.kde.ckde_cv_slogl`). Python-defined factor types
fall back to the generic fit/slogl loop, preserving the extension contract.
"""

from __future__ import annotations

import math

import numpy as np

from ...data import CrossValidation, DataFrame, HoldOut
from ...factors.base import Arguments
from ...factors.discrete import DiscreteFactorType
from ...factors.lineargaussian import LinearGaussianCPDType
from ...utils.exceptions import SingularCovarianceData
from .base import Score, ValidatedScore

__all__ = ["CVLikelihood", "HoldoutLikelihood", "ValidatedLikelihood"]


def _next_pow2(x: int, floor: int = 1) -> int:
    n = max(floor, 1)
    while n < x:
        n *= 2
    return n


def _fused_cv_scores(data, null_mask, col_idx, col_mask, tr_idx, tr_mask,
                     te_idx, te_mask, chunk, rule):
    """One fused CV-CKDE batch on the kernel that
    :func:`pybnesian_tpu.ops.kde.cv_pairs_route` picks for this platform and
    dtype: the streaming Pallas kernel for float32 on a GPU, the XLA kernel
    otherwise."""
    import jax

    from ...ops.kde import (
        ckde_cv_alldevice,
        ckde_cv_alldevice_flash,
        cv_pairs_route,
    )

    if cv_pairs_route(jax.default_backend(), data.dtype) == "triton":
        return ckde_cv_alldevice_flash(
            data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx,
            te_mask, rule=rule,
        )
    return ckde_cv_alldevice(
        data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx,
        te_mask, chunk=chunk, rule=rule,
    )


def _ckde_selector(node_type, model, variable, parents, args):
    """Instantiate the factor once to honour Arguments-configured bandwidth
    selectors (factors/arguments.hpp routing)."""
    a, kw = args.args(variable, node_type)
    factor = node_type.new_factor(model, variable, list(parents), *a, **kw)
    return factor.bandwidth_selector()


class _KFoldEngine:
    """Shared device-path CV evaluation over a fixed fold split."""

    def __init__(self, df: DataFrame, folds: list[tuple[np.ndarray, np.ndarray]]):
        self.df = df
        self.folds = folds

    # ------------------------------------------------------------------ LG
    def lg_batch(self, families) -> np.ndarray:
        """families: list of (var_pos, [parent_pos]). One device call."""
        import jax.numpy as jnp

        from ...ops.gaussian import batched_lg_cv_loglik

        cols = self.df.continuous_columns()
        values, valid = self.df.device_matrix(cols)
        n = self.df.num_rows
        K = len(self.folds)
        if not hasattr(self, "_masks"):
            train = np.zeros((K, n), np.float64)
            test = np.zeros((K, n), np.float64)
            for k, (tr, te) in enumerate(self.folds):
                train[k, tr] = 1.0
                test[k, te] = 1.0
            self._masks = (
                jnp.asarray(train.astype(values.dtype)),
                jnp.asarray(test.astype(values.dtype)),
            )
        train_mask, test_mask = self._masks
        F = len(families)
        Fb = _next_pow2(F, 8)
        P = max((len(ps) for _, ps in families), default=0)
        Pb = _next_pow2(max(P, 1))
        var_idx = np.zeros(Fb, np.int32)
        parent_idx = np.zeros((Fb, Pb), np.int32)
        parent_mask = np.zeros((Fb, Pb), values.dtype)
        for f, (vi, ps) in enumerate(families):
            var_idx[f] = vi
            for j, p in enumerate(ps):
                parent_idx[f, j] = p
                parent_mask[f, j] = 1.0
        out = batched_lg_cv_loglik(
            values,
            valid,
            train_mask,
            test_mask,
            jnp.asarray(var_idx),
            jnp.asarray(parent_idx),
            jnp.asarray(parent_mask),
        )
        return np.asarray(out, dtype=np.float64)[:F]

    # ---------------------------------------------------------------- CKDE
    def _family_arrays(self):
        """Cached full continuous matrix + per-column null masks (host)."""
        if not hasattr(self, "_fam_cache"):
            cols = self.df.continuous_columns()
            mat = self.df.to_numpy(cols, drop_null=False, dtype=np.float64)
            nulls = np.column_stack(
                [self.df.col(c).null_mask() for c in cols]
            ) if cols else np.zeros((self.df.num_rows, 0), bool)
            self._fam_cache = ({c: i for i, c in enumerate(cols)}, mat, nulls)
        return self._fam_cache

    @staticmethod
    def _rule_bandwidth(selector, train, n, d):
        """Fast path for the closed-form selectors; None -> generic path."""
        from ...kde.bandwidth import NormalReferenceRule, ScottsBandwidth

        if type(selector) is NormalReferenceRule:
            if n <= d:
                raise SingularCovarianceData("not enough rows")
            k = (4.0 / (n * (d + 2.0))) ** (2.0 / (d + 4.0))
            return k * np.cov(train, rowvar=False, ddof=1).reshape(d, d)
        if type(selector) is ScottsBandwidth:
            if n <= d:
                raise SingularCovarianceData("not enough rows")
            return n ** (-2.0 / (d + 4.0)) * np.cov(
                train, rowvar=False, ddof=1
            ).reshape(d, d)
        return None

    def _prepare_ckde_family(self, variable, parents, selector, ntr, nte,
                             dtype, h_per_fold=None):
        """Whitened per-fold blocks for one family; None => -inf.
        ``h_per_fold`` short-circuits the selector with precomputed
        bandwidths (one per fold) — the batched-UCV path supplies them."""
        from scipy.linalg import solve_triangular

        pos, full_mat, nulls = self._family_arrays()
        cols = [variable, *parents]
        cidx = [pos[c] for c in cols]
        mat = full_mat[:, cidx]
        valid = ~nulls[:, cidx].any(axis=1)
        dj = len(cols)
        K = len(self.folds)
        jtr = np.zeros((K, ntr, dj), dtype)
        jte = np.zeros((K, nte, dj), dtype)
        dm = max(dj - 1, 1)
        mtr = np.zeros((K, ntr, dm), dtype)
        mte = np.zeros((K, nte, dm), dtype)
        trm = np.zeros((K, ntr), dtype)
        tem = np.zeros((K, nte), dtype)
        jln = np.zeros(K, dtype)
        mln = np.zeros(K, dtype)
        for k, (tr, te) in enumerate(self.folds):
            tr = tr[valid[tr]]
            te = te[valid[te]]
            train = mat[tr]
            test = mat[te]
            ntr_k = len(train)
            if ntr_k <= dj:
                return None
            try:
                if h_per_fold is not None:
                    H = h_per_fold[k]
                else:
                    H = self._rule_bandwidth(selector, train, ntr_k, dj)
                    if H is None:
                        H = np.asarray(
                            selector.bandwidth(self.df.take(tr), cols),
                            dtype=np.float64,
                        )
                L = np.linalg.cholesky(H)
            except (SingularCovarianceData, np.linalg.LinAlgError):
                return None
            jtr[k, :ntr_k] = solve_triangular(L, train.T, lower=True).T
            jte[k, : len(test)] = solve_triangular(L, test.T, lower=True).T
            trm[k, :ntr_k] = 1.0
            tem[k, : len(te)] = 1.0
            jln[k] = (
                -np.sum(np.log(np.diag(L)))
                - 0.5 * dj * math.log(2 * math.pi)
                - math.log(ntr_k)
            )
            if dj > 1:
                Lm = np.linalg.cholesky(H[1:, 1:])
                mtr[k, :ntr_k] = solve_triangular(
                    Lm, train[:, 1:].T, lower=True
                ).T
                mte[k, : len(test)] = solve_triangular(
                    Lm, test[:, 1:].T, lower=True
                ).T
                mln[k] = (
                    -np.sum(np.log(np.diag(Lm)))
                    - 0.5 * (dj - 1) * math.log(2 * math.pi)
                    - math.log(ntr_k)
                )
        return jtr, jte, mtr, mte, trm, tem, jln, mln

    def _fold_pad_sizes(self, chunk=256):
        if not hasattr(self, "_pad_sizes"):
            ntr = max(len(tr) for tr, _ in self.folds)
            nte = max(len(te) for _, te in self.folds)
            # pad to lane multiples, not powers of two (9000 -> 9216, not 16384)
            self._pad_sizes = (
                -(-max(ntr, 1) // 256) * 256,
                -(-max(nte, 1) // chunk) * chunk,
            )
        return self._pad_sizes

    def _device_cv_cache(self, chunk=256):
        """Device-resident data + fold index arrays, uploaded once."""
        if not hasattr(self, "_dev_cv"):
            import jax.numpy as jnp

            cols = self.df.continuous_columns()
            pos, mat, nulls = self._family_arrays()
            ntr, nte = self._fold_pad_sizes(chunk)
            K = len(self.folds)
            tr_idx = np.zeros((K, ntr), np.int32)
            tr_mask = np.zeros((K, ntr), np.float64)
            te_idx = np.zeros((K, nte), np.int32)
            te_mask = np.zeros((K, nte), np.float64)
            for k, (tr, te) in enumerate(self.folds):
                tr_idx[k, : len(tr)] = tr
                tr_mask[k, : len(tr)] = 1.0
                te_idx[k, : len(te)] = te
                te_mask[k, : len(te)] = 1.0
            dt = self.df.same_type(*cols) if cols else np.float64
            dtype = np.float32 if np.dtype(dt) == np.float32 else np.float64
            self._dev_cv = (
                pos,
                jnp.asarray(np.nan_to_num(mat, nan=0.0).astype(dtype)),
                jnp.asarray(nulls.astype(dtype)),
                jnp.asarray(tr_idx),
                jnp.asarray(tr_mask.astype(dtype)),
                jnp.asarray(te_idx),
                jnp.asarray(te_mask.astype(dtype)),
                dtype,
            )
        return self._dev_cv

    def ckde_scores_batch(self, fams) -> np.ndarray:
        """fams: list of (variable, parents, selector). Rule-based selectors
        ride the fully-fused device kernel
        (:func:`pybnesian_tpu.ops.kde.ckde_cv_alldevice`); custom Python
        selectors fall back to the host-whitened per-family path."""
        import jax.numpy as jnp

        from ...kde.bandwidth import NormalReferenceRule, ScottsBandwidth
        from ...kde.ucv import UCV

        chunk = 256
        out = np.empty(len(fams))
        device_groups: dict[tuple, list[int]] = {}
        ucv_idx: list[int] = []
        fallback: list[int] = []
        for i, (v, ps, selector) in enumerate(fams):
            if type(selector) is NormalReferenceRule:
                rule = "nr"
            elif type(selector) is ScottsBandwidth:
                rule = "scott"
            elif type(selector) is UCV:
                ucv_idx.append(i)
                continue
            else:
                fallback.append(i)
                continue
            # one group per RULE: families of every width share a launch
            # (padding extra columns only widens the cheap distance loop;
            # each synchronous device call costs a dispatch round trip)
            device_groups.setdefault(rule, []).append(i)

        if device_groups:
            (pos, data, null_mask, tr_idx, tr_mask, te_idx, te_mask, dtype) = (
                self._device_cv_cache(chunk)
            )
            # phase 1: dispatch every group's launch asynchronously
            pending = []
            for rule, idxs in device_groups.items():
                F = len(idxs)
                djmax = _next_pow2(
                    max(len(fams[i][1]) + 1 for i in idxs), 2
                )
                # two-bucket family padding: {4, 16} at ≤20k rows (then
                # pow2 beyond 16). Hill-climbing's update_scores batches are
                # often 2-6 families; padding those to 16 wasted 3-5× of the
                # dominant pairwise work, while capping the bucket set keeps
                # the number of distinct compiled shapes at two for the
                # common sizes (each distinct shape costs a slow remote XLA
                # compile on this backend).
                if self.df.num_rows <= 20_000:
                    Fb = 4 if F <= 4 else _next_pow2(F, 16)
                else:
                    Fb = _next_pow2(F, 4)
                col_idx = np.zeros((Fb, djmax), np.int32)
                col_mask = np.zeros((Fb, djmax), dtype)
                for f, i in enumerate(idxs):
                    v, ps, _ = fams[i]
                    # evidence first, variable last (kernel layout: joint and
                    # marginal share the Cholesky leading block)
                    cols = [*ps, v]
                    for j, c in enumerate(cols):
                        col_idx[f, j] = pos[c]
                        col_mask[f, j] = 1.0
                col_mask[F:, 0] = 1.0  # padded families: 1-D dummy
                scores = _fused_cv_scores(
                    data, null_mask,
                    jnp.asarray(col_idx), jnp.asarray(col_mask),
                    tr_idx, tr_mask, te_idx, te_mask,
                    chunk=chunk, rule=rule,
                )
                pending.append((idxs, F, scores))
            # phase 2: one blocking collect per group
            for idxs, F, scores in pending:
                vals = np.array(scores, np.float64)[:F].copy()
                vals[~np.isfinite(vals)] = -math.inf
                out[np.array(idxs)] = vals

        if ucv_idx:
            out[np.array(ucv_idx)] = self._ckde_ucv_batch(
                [fams[i] for i in ucv_idx], chunk
            )
        if fallback:
            out[np.array(fallback)] = self._ckde_host_batch(
                [fams[i] for i in fallback], chunk
            )
        return out

    def _ckde_ucv_batch(self, fams, chunk=256) -> np.ndarray:
        """UCV-selected CKDE families on the batched device pipeline: every
        (family, fold) bandwidth problem runs through ONE vmapped device
        Nelder–Mead (:func:`pybnesian_tpu.kde.ucv.ucv_minimize_batch`), and
        the optimal factors feed the standard whitened-parts scoring
        kernels. Replaces F·K sequential dispatch-bound optimizations
        (reference kde/UCV.cpp runs one NLopt loop per factor fit)."""
        from ...kde.ucv import invvech_triangular, ucv_minimize_batch, vech

        pos, full_mat, nulls = self._family_arrays()
        K = len(self.folds)
        out = np.full(len(fams), -math.inf)
        probs_by_dj: dict[int, list] = {}
        for i, (v, ps, _sel) in enumerate(fams):
            cols = [v, *ps]
            cidx = [pos[c] for c in cols]
            valid = ~nulls[:, cidx].any(axis=1)
            dj = len(cols)
            trains = []
            ok = True
            for (tr, _te) in self.folds:
                trk = tr[valid[tr]]
                train = full_mat[np.ix_(trk, cidx)]
                n_k = len(train)
                if n_k <= dj:
                    ok = False
                    break
                # normal-reference start (UCV.cpp:400: NR is the x0)
                knr = (4.0 / (n_k * (dj + 2.0))) ** (2.0 / (dj + 4.0))
                H0 = knr * np.cov(train, rowvar=False, ddof=1).reshape(
                    dj, dj
                )
                try:
                    L0 = np.linalg.cholesky(H0)
                except np.linalg.LinAlgError:
                    ok = False
                    break
                trains.append((train, L0))
            if ok:
                probs_by_dj.setdefault(dj, []).append((i, trains))

        h_maps: dict[int, list] = {}
        ucv_chunk = 512
        for dj, entries in probs_by_dj.items():
            B = len(entries) * K
            nv = dj * (dj + 1) // 2
            max_n = max(
                len(train) for (_i, trains) in entries
                for (train, _L) in trains
            )
            npad = -(-max(max_n, 1) // ucv_chunk) * ucv_chunk
            Xpad = np.zeros((B, npad, dj))
            validm = np.zeros((B, npad))
            Ns = np.zeros(B)
            x0s = np.zeros((B, nv))
            for b, (_i, trains) in enumerate(entries):
                for k, (train, L0) in enumerate(trains):
                    row = b * K + k
                    Xpad[row, : len(train)] = train
                    validm[row, : len(train)] = 1.0
                    Ns[row] = len(train)
                    x0s[row] = vech(L0)
            xb = ucv_minimize_batch(Xpad, validm, Ns, x0s, dj,
                                    chunk=ucv_chunk)
            for b, (i, _trains) in enumerate(entries):
                hs = []
                for k in range(K):
                    L = invvech_triangular(xb[b * K + k])
                    hs.append(L @ L.T)
                h_maps[i] = hs

        if h_maps:
            idxs = sorted(h_maps)
            out[np.array(idxs)] = self._ckde_host_batch(
                [fams[i] for i in idxs], chunk,
                h_maps=[h_maps[i] for i in idxs],
            )
        return out

    def _ckde_host_batch(self, fams, chunk=256, h_maps=None) -> np.ndarray:
        """Host-whitened path for user-defined bandwidth selectors (or for
        precomputed per-fold bandwidths via ``h_maps``)."""
        import jax.numpy as jnp

        from ...ops.kde import batched_ckde_cv_slogl, batched_kde_cv_slogl

        ntr, nte = self._fold_pad_sizes(chunk)
        dt = self.df.same_type(*self.df.continuous_columns())
        dtype = np.float32 if np.dtype(dt) == np.float32 else np.float64
        out = np.empty(len(fams))
        groups: dict[int, list[int]] = {}
        prepared = {}
        for i, (v, ps, selector) in enumerate(fams):
            arrs = self._prepare_ckde_family(
                v, ps, selector, ntr, nte, dtype,
                h_per_fold=None if h_maps is None else h_maps[i],
            )
            if arrs is None:
                out[i] = -math.inf
                continue
            prepared[i] = arrs
            groups.setdefault(len(ps) + 1, []).append(i)
        for dj, idxs in groups.items():
            stacks = [
                np.stack([prepared[i][j] for i in idxs]) for j in range(8)
            ]
            if dj > 1:
                scores = batched_ckde_cv_slogl(
                    *(jnp.asarray(s) for s in stacks), chunk=chunk
                )
            else:
                jtr, jte, _, _, trm, tem, jln, _ = stacks
                scores = batched_kde_cv_slogl(
                    jnp.asarray(jtr), jnp.asarray(jte), jnp.asarray(trm),
                    jnp.asarray(tem), jnp.asarray(jln), chunk=chunk,
                )
            out[np.array(idxs)] = np.asarray(scores, np.float64)
        return out

    def ckde_score(self, variable, parents, selector) -> float:
        return float(self.ckde_scores_batch([(variable, parents, selector)])[0])

    # ------------------------------------------------------------ discrete
    def discrete_score(self, variable, parents) -> float:
        """All folds in one pass: the per-fold CPT fit is a bincount over
        the cached flat configuration index, and the per-fold slogl is the
        dot product of test-fold counts with the fold's log-CPT — no
        DataFrame slices, no per-fold factor objects (reference
        cv_likelihood.cpp:11-25 fits and scores a DiscreteFactor per
        fold). Bit-identical to the serial path: same counts → same CPT →
        same sum (unseen configs with seen parents contribute −inf, unseen
        parent configs the log-uniform fallback)."""
        from ...factors.discrete import create_cardinality_strides, flat_indices

        parents = list(parents)
        for v in (variable, *parents):
            if not self.df.is_discrete(v):
                raise ValueError(
                    "Wrong data type to fit DiscreteFactor. Column "
                    f"'{v}' is not categorical."
                )
        card, strides = create_cardinality_strides(self.df, variable, parents)
        C = int(np.prod(card))
        k = int(card[0])
        npc = C // k
        idx = flat_indices(self.df, [variable, *parents], strides)
        log_uniform = -math.log(k)
        total = 0.0
        for (tr, te) in self.folds:
            tr_i = idx[tr]
            tr_i = tr_i[tr_i >= 0]
            counts_tr = np.bincount(tr_i, minlength=C).reshape(npc, k)
            totals = counts_tr.sum(axis=1, keepdims=True)
            with np.errstate(divide="ignore", invalid="ignore"):
                logp = np.log(counts_tr) - np.log(totals)
            logp[totals[:, 0] == 0, :] = log_uniform
            te_i = idx[te]
            te_i = te_i[te_i >= 0]
            counts_te = np.bincount(te_i, minlength=C).reshape(npc, k)
            seen = counts_te > 0
            total += float(np.sum(counts_te[seen] * logp[seen]))
        return total

    # ------------------------------------------------------------- generic
    def generic_score(self, model, node_type, variable, parents, args) -> float:
        a, kw = args.args(variable, node_type)
        total = 0.0
        for (tr, te) in self.folds:
            factor = node_type.new_factor(model, variable, list(parents), *a, **kw)
            try:
                factor.fit(self.df.take(tr))
            except SingularCovarianceData:
                return -math.inf
            total += factor.slogl(self.df.take(te))
        return total


class CVLikelihood(Score):
    """(reference cv_likelihood.{hpp,cpp})."""

    def __init__(self, df, k: int = 10, seed: int = 0,
                 construction_args: Arguments | None = None):
        self.df = DataFrame.wrap(df)
        self.cv = CrossValidation(self.df, k, seed)
        self.k = k
        self.seed = seed
        self.args = construction_args or Arguments()
        self._engine = _KFoldEngine(
            self.df, [self.cv.fold_indices(i) for i in range(k)]
        )

    def data(self):
        return self.df

    def cv_folds(self):
        return self.cv

    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        parents = list(parents)
        from ...factors.ckde import CKDEType

        if node_type == LinearGaussianCPDType() and self._lg_ok(variable, parents):
            pos = {c: i for i, c in enumerate(self.df.continuous_columns())}
            fams = [(pos[variable], [pos[p] for p in parents])]
            return float(self._engine.lg_batch(fams)[0])
        if node_type == CKDEType() and self._lg_ok(variable, parents):
            selector = _ckde_selector(node_type, model, variable, parents, self.args)
            return self._engine.ckde_score(variable, parents, selector)
        if node_type == DiscreteFactorType():
            return self._engine.discrete_score(variable, parents)
        return self._engine.generic_score(
            model, node_type, variable, parents, self.args
        )

    def _lg_ok(self, variable, parents) -> bool:
        return not self.df.is_discrete(variable) and not any(
            self.df.is_discrete(p) for p in parents
        )

    def local_score_batch(self, model, families) -> np.ndarray:
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
        lg_idx = [
            i
            for i, (v, ps, nt) in enumerate(norm)
            if nt == LinearGaussianCPDType() and self._lg_ok(v, ps)
        ]
        pos = {c: i for i, c in enumerate(self.df.continuous_columns())}
        if lg_idx:
            fams = [
                (pos[norm[i][0]], [pos[p] for p in norm[i][1]]) for i in lg_idx
            ]
            out[np.array(lg_idx)] = self._engine.lg_batch(fams)
        from ...factors.ckde import CKDEType

        ckde_idx = [
            i
            for i, (v, ps, nt) in enumerate(norm)
            if nt == CKDEType() and self._lg_ok(v, ps)
        ]
        if ckde_idx:
            fams = [
                (
                    norm[i][0],
                    norm[i][1],
                    _ckde_selector(norm[i][2], model, norm[i][0], norm[i][1],
                                   self.args),
                )
                for i in ckde_idx
            ]
            out[np.array(ckde_idx)] = self._engine.ckde_scores_batch(fams)
        handled = set(lg_idx) | set(ckde_idx)
        for i, (v, ps, nt) in enumerate(norm):
            if i in handled:
                continue
            out[i] = self.local_score_node_type(model, nt, v, ps)
        return out

    def ToString(self) -> str:
        return "CVLikelihood"


class HoldoutLikelihood(Score):
    """(reference holdout_likelihood.{hpp,cpp})."""

    def __init__(self, df, test_ratio: float = 0.2, seed: int = 0,
                 construction_args: Arguments | None = None):
        self.df = DataFrame.wrap(df)
        self.holdout = HoldOut(self.df, test_ratio, seed)
        self.args = construction_args or Arguments()
        self._train = self.holdout.training_data()
        self._test = self.holdout.test_data()
        # fused device path: the holdout split is one (train, test) "fold"
        self._engine = _KFoldEngine(
            self.df, [(self.holdout._train_idx, self.holdout._test_idx)]
        )

    def data(self):
        return self._train

    def training_data(self):
        return self._train

    def test_data(self):
        return self._test

    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        parents = list(parents)
        a, kw = self.args.args(variable, node_type)
        factor = node_type.new_factor(model, variable, parents, *a, **kw)
        try:
            factor.fit(self._train)
        except SingularCovarianceData:
            return -math.inf
        return factor.slogl(self._test)

    def local_score_batch(self, model, families) -> np.ndarray:
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
        cont = self._train.continuous_columns()
        pos = {c: i for i, c in enumerate(cont)}
        lg_idx = [
            i
            for i, (v, ps, nt) in enumerate(norm)
            if nt == LinearGaussianCPDType()
            and not self._train.is_discrete(v)
            and not any(self._train.is_discrete(p) for p in ps)
        ]
        if lg_idx:
            import jax.numpy as jnp

            from ...ops.gaussian import batched_lg_holdout_loglik

            tv, tvalid = self._train.device_matrix(cont)
            sv, svalid = self._test.device_matrix(cont)
            F = len(lg_idx)
            Fb = _next_pow2(F, 8)
            P = max((len(norm[i][1]) for i in lg_idx), default=0)
            Pb = _next_pow2(max(P, 1))
            var_idx = np.zeros(Fb, np.int32)
            parent_idx = np.zeros((Fb, Pb), np.int32)
            parent_mask = np.zeros((Fb, Pb), tv.dtype)
            for f, i in enumerate(lg_idx):
                var_idx[f] = pos[norm[i][0]]
                for j, p in enumerate(norm[i][1]):
                    parent_idx[f, j] = pos[p]
                    parent_mask[f, j] = 1.0
            scores = batched_lg_holdout_loglik(
                tv, tvalid, sv, svalid,
                jnp.asarray(var_idx),
                jnp.asarray(parent_idx),
                jnp.asarray(parent_mask),
            )
            out[np.array(lg_idx)] = np.asarray(scores, dtype=np.float64)[:F]
        from ...factors.ckde import CKDEType

        ckde_idx = [
            i
            for i, (v, ps, nt) in enumerate(norm)
            if nt == CKDEType()
            and not self._train.is_discrete(v)
            and not any(self._train.is_discrete(p) for p in ps)
        ]
        if ckde_idx:
            fams = [
                (
                    norm[i][0],
                    norm[i][1],
                    _ckde_selector(norm[i][2], model, norm[i][0], norm[i][1],
                                   self.args),
                )
                for i in ckde_idx
            ]
            out[np.array(ckde_idx)] = self._engine.ckde_scores_batch(fams)
        handled = set(lg_idx) | set(ckde_idx)
        for i, (v, ps, nt) in enumerate(norm):
            if i in handled:
                continue
            out[i] = self.local_score_node_type(model, nt, v, ps)
        return out

    def ToString(self) -> str:
        return "HoldoutLikelihood"


class ValidatedLikelihood(ValidatedScore):
    """Main channel: CV over the holdout-training part; validation channel:
    holdout test (reference validated_likelihood.hpp:12-80)."""

    def __init__(self, df, test_ratio: float = 0.2, k: int = 10, seed: int = 0,
                 construction_args: Arguments | None = None):
        self.df = DataFrame.wrap(df)
        self.holdout = HoldoutLikelihood(
            self.df, test_ratio, seed, construction_args
        )
        self.cv = CVLikelihood(
            self.holdout.training_data(), k, seed, construction_args
        )

    def data(self):
        return self.cv.df

    def training_data(self):
        return self.holdout.training_data()

    @property
    def holdout_lik(self):
        """HoldoutLikelihood component (read-only property, reference
        pybindings_scores.cpp:644)."""
        return self.holdout

    def validation_data(self):
        """Holdout test split backing the validation channel
        (pybindings_scores.cpp:653)."""
        return self.holdout.test_data()

    @property
    def cv_lik(self):
        """CVLikelihood component (read-only property, reference
        pybindings_scores.cpp:647)."""
        return self.cv

    def local_score_node_type(self, model, node_type, variable, parents) -> float:
        return self.cv.local_score_node_type(model, node_type, variable, parents)

    def local_score_batch(self, model, families) -> np.ndarray:
        return self.cv.local_score_batch(model, families)

    def vlocal_score_node_type(self, model, node_type, variable, parents) -> float:
        return self.holdout.local_score_node_type(
            model, node_type, variable, parents
        )

    def vlocal_score_batch(self, model, families) -> np.ndarray:
        return self.holdout.local_score_batch(model, families)

    def ToString(self) -> str:
        return "ValidatedLikelihood"
