"""RCoT: randomized conditional correlation test (Strobl et al. 2019).

Rebuild of reference learning/independences/continuous/RCoT.{hpp,cpp}:
random Fourier features (5 for x/y, 100 for z by default), median-heuristic
kernel widths (rf_sigma_impl, RCoT.hpp:16-41), residualisation of the x/y
features against z, statistic = N·‖cov(resid_x, resid_y)‖², null distribution
= weighted χ² sum via LPB4 with HBE fallback (RCoT.hpp:340-395).
The feature products and eigenvalues run as dense matrix algebra — on device
this is a handful of (N × 100) matmuls, all at ``Precision.HIGHEST`` (the
default lets a GPU use TF32).
"""

from __future__ import annotations

import math

import numpy as np

from ...data import DataFrame
from ...utils.chisquaresum import (
    chisq_sum_pvalues_batch,
    hbe_complement,
    lpb4_complement,
)
from .base import DynamicIndependenceTest, IndependenceTest

__all__ = ["RCoT", "DynamicRCoT"]


def rf_sigma(m: np.ndarray) -> float:
    """Median pairwise distance over the first min(500, n) rows
    (reference rf_sigma_impl)."""
    if m.ndim == 1:
        m = m[:, None]
    r = min(500, len(m))
    sub = m[:r]
    d = np.sqrt(
        np.maximum(
            ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1), 0.0
        )
    )
    iu = np.triu_indices(r, k=1)
    med = float(np.median(d[iu]))
    return med if med != 0 else 1.0


def _rff_kernel():
    """Jitted feature map with column normalization fused in — XLA's
    vectorized cos is ~60× numpy's libm loop on large feature blocks (the z
    block is (n, 100) per test), and keeping normalization on device avoids
    a (n, 100) D2H+H2D round trip per test."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(m, W, b):
        proj = jnp.matmul(m, W, precision=jax.lax.Precision.HIGHEST)
        feat = jnp.sqrt(2.0) * jnp.cos(proj + b[None, :])
        mean = jnp.mean(feat, axis=0, keepdims=True)
        sd = jnp.std(feat, axis=0, ddof=1, keepdims=True)
        sd = jnp.where(sd == 0, 1.0, sd)
        return (feat - mean) / sd

    return f


_rff = None


def random_fourier_features(m: np.ndarray, sigma: float, num_features: int,
                            rng) -> np.ndarray:
    """√2·cos(mW/σ + b) with W ~ N(0,1), b ~ U(0, 2π)
    (reference RCoT.hpp:209-241). Draws on host (rng parity), evaluates the
    feature map with XLA."""
    global _rff
    if m.ndim == 1:
        m = m[:, None]
    W = rng.standard_normal((m.shape[1], num_features)) / sigma
    b = rng.uniform(0, 2 * np.pi, num_features)
    if _rff is None:
        _rff = _rff_kernel()
    # returns the DEVICE array (columns already normalized) — downstream
    # covariance/eigen kernels consume it without leaving the device
    return _rff(m, W, b)





_TRIU_CACHE: dict[int, tuple] = {}


def _rf_sigma_cols(m: np.ndarray) -> float:
    """``rf_sigma`` via the Gram trick (a²+b²−2ab in f64 — no cancellation
    trouble at 500 rows): O(r²·d) flops through BLAS instead of an
    (r, r, d) broadcast, and the median taken on SQUARED distances
    (median commutes with the monotone sqrt) so the 125k-element sqrt
    disappears."""
    if m.ndim == 1:
        m = m[:, None]
    r = min(500, len(m))
    sub = np.asarray(m[:r], np.float64)
    sq = np.einsum("ij,ij->i", sub, sub)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (sub @ sub.T)
    iu = _TRIU_CACHE.get(r)
    if iu is None:
        iu = np.triu_indices(r, k=1)
        _TRIU_CACHE[r] = iu
    med = math.sqrt(max(float(np.median(d2[iu])), 0.0))
    return med if med != 0 else 1.0


def _batched_kernels():
    """Jitted batch kernels: ONE launch evaluates B conditional tests
    end-to-end (see ``fused_z``), another a batch of marginal tests. All
    tests of a PC order sweep share the launches, amortising the dispatch
    round trip B ways."""
    import jax
    import jax.numpy as jnp

    def _nrm(feat):
        mean = jnp.mean(feat, axis=1, keepdims=True)
        sd = jnp.std(feat, axis=1, ddof=1, keepdims=True)
        sd = jnp.where(sd == 0, 1.0, sd)
        return (feat - mean) / sd

    def _feat1(data, col, W, b):
        # data: (n, C) device-resident; col: (B,) column gather; W/b: (B, f)
        X = data[:, col].T  # (B, n)
        return _nrm(jnp.sqrt(2.0) * jnp.cos(
            X[:, :, None] * W[:, None, :] + b[:, None, :]
        ))

    def _featk(data, cols, cmask, W, b):
        # data: (n, C); cols: (B, d) gather + (B, d) pad mask; W: (B, d, f)
        Z = jnp.transpose(data[:, cols], (1, 0, 2)) * cmask[:, None, :]
        prod = jnp.einsum("bnd,bdf->bnf", Z, W,
                          precision=jax.lax.Precision.HIGHEST)
        return _nrm(jnp.sqrt(2.0) * jnp.cos(prod + b[:, None, :]))

    def _cov(a, b, n):
        ac = a - jnp.mean(a, axis=1, keepdims=True)
        bc = b - jnp.mean(b, axis=1, keepdims=True)
        return jnp.einsum(
            "bnc,bnd->bcd", ac, bc,
            precision=jax.lax.Precision.HIGHEST,
        ) / (n - 1.0)

    def _prod_eigs(a, b, n):
        prod = (a[:, :, :, None] * b[:, :, None, :]).reshape(
            a.shape[0], n, -1
        )
        centred = prod - jnp.mean(prod, axis=1, keepdims=True)
        covp = jnp.einsum(
            "bnc,bnd->bcd", centred, centred,
            precision=jax.lax.Precision.HIGHEST,
        ) / n
        return jnp.linalg.eigvalsh(covp)

    @jax.jit
    def fused_z(data, xc, Wx, bx, yc, Wy, by, zc, zm, Wz, bz):
        """The ENTIRE conditional test in one launch: feature maps,
        covariances, the (num_z × num_z) conditioning solve, residual
        products and their eigendecomposition. The ill-conditioned solve
        runs as a jittered Cholesky (czz has a UNIT diagonal — the feature
        columns are standardized — so +1e-5·I is a relative ridge just
        above the f32 Gram noise floor). The serial path applies the SAME
        1e-5 ridge (round-5 unification: with a shared feature draw the
        two routes now differ only by f32-vs-f64 arithmetic, pinned by
        tests/learning/test_rcot_solve_parity.py). Returns only (B,)
        statistics and (B, num_xy²) eigenvalues, so the D2H fetch is
        tiny."""
        n = data.shape[0]
        fx = _feat1(data, xc, Wx, bx)
        fy = _feat1(data, yc, Wy, by)
        fz = _featk(data, zc, zm, Wz, bz)
        cxy = _cov(fx, fy, n)
        czz = _cov(fz, fz, n)
        cxz = _cov(fx, fz, n)
        czy = _cov(fz, fy, n)
        eye = jnp.eye(czz.shape[-1], dtype=czz.dtype)
        L = jnp.linalg.cholesky(czz + 1e-5 * eye)
        B1 = jax.scipy.linalg.cho_solve((L, True),
                                        jnp.swapaxes(cxz, 1, 2))
        B2 = jax.scipy.linalg.cho_solve((L, True), czy)
        cxy_z = cxy - jnp.matmul(cxz, B2, precision=jax.lax.Precision.HIGHEST)
        sta = n * jnp.sum(cxy_z**2, axis=(1, 2))
        rx = fx - jnp.einsum("bnf,bfc->bnc", fz, B1,
                             precision=jax.lax.Precision.HIGHEST)
        ry = fy - jnp.einsum("bnf,bfc->bnc", fz, B2,
                             precision=jax.lax.Precision.HIGHEST)
        return sta, _prod_eigs(rx, ry, n)

    @jax.jit
    def pair_stats(data, xc, Wx, bx, yc, Wy, by):
        n = data.shape[0]
        fx = _feat1(data, xc, Wx, bx)
        fy = _feat1(data, yc, Wy, by)
        cxy = _cov(fx, fy, n)
        return jnp.sum(cxy**2, axis=(1, 2)), _prod_eigs(fx, fy, n)

    return fused_z, pair_stats


_batched = None
_pack = None


def _pack_fetch(sta_d, eigs_d):
    """Fetch (statistics, eigenvalues) as ONE D2H transfer: dispatches are
    async, but every separate np.asarray waits for its own device-to-host
    round trip, so packing on device halves the per-chunk syncs."""
    global _pack
    if _pack is None:
        import jax
        import jax.numpy as jnp

        _pack = jax.jit(
            lambda s, e: jnp.concatenate([s[:, None], e], axis=1)
        )
    arr = np.asarray(_pack(sta_d, eigs_d), np.float64)
    return arr[:, 0], arr[:, 1:]


def _get_batched():
    """Lazily built (fused_z, pair_stats) batch kernels — also the entry
    point the multi-chip dryrun uses to validate the fused conditional
    batch under a sharded test axis."""
    global _batched
    if _batched is None:
        _batched = _batched_kernels()
    return _batched


def _twz_kernels():
    import jax
    import jax.numpy as jnp

    def _cov_d(a, b, n):
        ac = a - jnp.mean(a, axis=0, keepdims=True)
        bc = b - jnp.mean(b, axis=0, keepdims=True)
        return jnp.dot(ac.T, bc,
                       precision=jax.lax.Precision.HIGHEST) / (n - 1.0)

    @jax.jit
    def covs(fx, fy, fz):
        n = fx.shape[0]
        return (_cov_d(fx, fy, n), _cov_d(fz, fz, n), _cov_d(fx, fz, n),
                _cov_d(fz, fy, n))

    @jax.jit
    def pair_stats(fx, fy):
        n = fx.shape[0]
        cxy = _cov_d(fx, fy, n)
        prod = (fx[:, :, None] * fy[:, None, :]).reshape(n, -1)
        centred = prod - jnp.mean(prod, axis=0, keepdims=True)
        covp = jnp.dot(centred.T, centred,
                       precision=jax.lax.Precision.HIGHEST) / n
        return jnp.sum(cxy**2), jnp.linalg.eigvalsh(covp)

    @jax.jit
    def resid_eigs(fx, fy, fz, B1, B2):
        n = fx.shape[0]
        rx = fx - jnp.matmul(fz, B1, precision=jax.lax.Precision.HIGHEST)
        ry = fy - jnp.matmul(fz, B2, precision=jax.lax.Precision.HIGHEST)
        prod = (rx[:, :, None] * ry[:, None, :]).reshape(n, -1)
        centred = prod - jnp.mean(prod, axis=0, keepdims=True)
        covp = jnp.dot(centred.T, centred,
                       precision=jax.lax.Precision.HIGHEST) / n
        return jnp.linalg.eigvalsh(covp)

    return covs, resid_eigs, pair_stats


_twz = None


def _test_with_z_core(fx, fy, fz):
    """Heavy O(n) algebra on device; the ill-conditioned 100×100 solve stays
    on host in float64 (an f32 Cholesky of czz can produce NaNs)."""
    global _twz
    if _twz is None:
        _twz = _twz_kernels()
    covs, resid_eigs, _ = _twz
    n = len(fx)
    cxy, czz, cxz, czy = (np.array(m, np.float64)
                          for m in covs(fx, fy, fz))
    # SAME relative ridge as the fused batch kernel (unit diagonal after
    # standardization); the reference uses a plain inverse (RCoT.hpp:355)
    # which this regularizes against f32-feature Gram noise
    czz[np.diag_indices_from(czz)] += 1e-5
    # host f64 LU solve (device czz may carry f32 noise that breaks a
    # strict Cholesky)
    B1 = np.linalg.solve(czz, cxz.T)   # i_czz @ cxz.T  (num_z, num_xy)
    B2 = np.linalg.solve(czz, czy)     # i_czz @ czy
    cxy_z = cxy - cxz @ B2
    sta = n * float(np.sum(cxy_z**2))
    eigs = resid_eigs(fx, fy, fz, B1.astype(fx.dtype), B2.astype(fx.dtype))
    return sta, eigs


def _pvalue_from_eigs(eigs: np.ndarray, sta: float) -> float:
    pos = eigs[eigs > 0]
    if len(pos) < 4:
        return max(hbe_complement(pos, sta), 0.0)
    try:
        return max(lpb4_complement(pos, sta), 0.0)
    except Exception:
        return max(hbe_complement(pos, sta), 0.0)


class RCoT(IndependenceTest):
    def __init__(self, df, random_fourier_xy: int = 5,
                 random_fourier_z: int = 100, seed: int | None = None):
        self.df = DataFrame.wrap(df)
        self.num_xy = int(random_fourier_xy)
        self.num_z = int(random_fourier_z)
        self._rng = np.random.default_rng(seed)
        # batched-path caches (full-column values + median-heuristic widths;
        # valid because the batch path only runs on null-free columns)
        self._col_cache: dict[str, np.ndarray] = {}
        self._sig1: dict[str, float] = {}
        self._sigz: dict[tuple, float] = {}
        for c in self.df.column_names():
            if not self.df.is_continuous(c):
                raise ValueError(
                    f"Column '{c}' is not continuous; RCoT requires "
                    "continuous data."
                )

    def variable_names(self) -> list[str]:
        return self.df.column_names()

    def _col(self, name, mask):
        return self.df.to_numpy([name], drop_null=False, dtype=np.float64)[
            mask, 0
        ]

    def pvalue(self, x: str, y: str, *z) -> float:
        z = list(z[0]) if len(z) == 1 and not isinstance(z[0], str) else list(z)
        mask = self.df.combined_mask(x, y, *z)
        xv = self._col(x, mask)
        yv = self._col(y, mask)
        if xv.var() == 0 or yv.var() == 0:
            return 1.0
        if z:
            zmat = np.column_stack([self._col(e, mask) for e in z])
            # drop constant z columns (reference RCoT.cpp:95-115)
            keep = zmat.var(axis=0) > 0
            zmat = zmat[:, keep]
            if zmat.shape[1] > 0:
                return self._test_with_z(xv, yv, zmat)
        return self._rit(xv, yv)

    def _rit(self, x: np.ndarray, y: np.ndarray) -> float:
        """(reference RIT_impl, RCoT.hpp:288-317)."""
        global _twz
        if _twz is None:
            _twz = _twz_kernels()
        _, _, pair_stats = _twz
        n = len(x)
        fx = random_fourier_features(x, rf_sigma(x), self.num_xy, self._rng)
        fy = random_fourier_features(y, rf_sigma(y), self.num_xy, self._rng)
        ssq, eigs = pair_stats(fx, fy)
        sta = n * float(ssq)
        return _pvalue_from_eigs(np.asarray(eigs, np.float64), sta)

    def _test_with_z(self, x: np.ndarray, y: np.ndarray, z: np.ndarray) -> float:
        """(reference TestWithZ_impl, RCoT.hpp:340-395). The residualisation
        and product-eigenvalue algebra run as ONE jitted device call."""
        fx = random_fourier_features(x, rf_sigma(x), self.num_xy, self._rng)
        fy = random_fourier_features(y, rf_sigma(y), self.num_xy, self._rng)
        sigma_z = rf_sigma(z)
        # pad z to a power-of-two width: padded columns are all-zero, and a
        # zero column contributes nothing to m @ W, so the feature values
        # are identical — but PC's growing conditioning sets then hit only
        # O(log d) compiled shapes instead of one per sepset size
        kz = z.shape[1]
        kp = 1
        while kp < kz:
            kp *= 2
        if kp != kz:
            z = np.concatenate([z, np.zeros((len(z), kp - kz))], axis=1)
        fz = random_fourier_features(z, sigma_z, self.num_z, self._rng)
        sta, eigs = _test_with_z_core(fx, fy, fz)
        return self._pvalue_tail(np.asarray(eigs, np.float64), sta)

    def _pvalue_tail(self, eigs: np.ndarray, sta: float) -> float:
        if self.num_z == 1:
            pos = eigs[eigs > 0]
            return max(hbe_complement(pos, sta), 0.0)
        return _pvalue_from_eigs(eigs, sta)

    # ------------------------------------------------------- batched path
    # f32-element budget per launch (~4 GB of intermediates); the dominant
    # per-test footprint is the (n, num_z) z-feature block plus the
    # (n, num_xy²) residual product.
    _ELEM_BUDGET = 1_000_000_000

    def _full_col(self, name: str) -> np.ndarray:
        col = self._col_cache.get(name)
        if col is None:
            col = self.df.to_numpy([name], drop_null=False,
                                   dtype=np.float64)[:, 0]
            self._col_cache[name] = col
        return col

    def _device_data(self):
        """All columns uploaded ONCE as an (n, C) device matrix; batched
        kernels gather their (x, y, Z) columns on device, so a chunk's H2D
        traffic is only the small W/b draw — not B stacked copies of
        100k-row columns."""
        if not hasattr(self, "_dev_data"):
            import jax.numpy as jnp

            names = self.df.column_names()
            mat = np.column_stack([self._full_col(c) for c in names])
            self._dev_data = jnp.asarray(mat.astype(np.float32))
            self._dev_pos = {c: i for i, c in enumerate(names)}
        return self._dev_data, self._dev_pos

    def _sigma1(self, name: str, col: np.ndarray) -> float:
        s = self._sig1.get(name)
        if s is None:
            s = rf_sigma(col)
            self._sig1[name] = s
        return s

    def _sigmaz(self, zcols: tuple, zmat: np.ndarray) -> float:
        s = self._sigz.get(zcols)
        if s is None:
            s = _rf_sigma_cols(zmat)
            self._sigz[zcols] = s
        return s

    def pvalue_batch(self, triples) -> np.ndarray:
        """Batched tests: stack the (x, y | Z) problems of one sweep, run
        the feature maps + covariances of ALL of them in one launch, solve
        the per-test (num_z × num_z) systems as one stacked host f64 solve,
        and batch the residual-product eigendecompositions in a second
        launch. Groups by conditioning-set size internally; tests over
        null-bearing columns fall back to the serial path (their row masks
        differ per test)."""
        triples = list(triples)
        out = np.empty(len(triples))
        cols = sorted({c for t in triples for c in (t[0], t[1], *t[2])})
        if any(self.df.null_count(c) > 0 for c in cols):
            return super().pvalue_batch(triples)
        data = {c: self._full_col(c) for c in cols}
        var = {c: float(data[c].var()) for c in cols}

        groups: dict[int, list] = {}
        for i, (x, y, zs) in enumerate(triples):
            if var[x] == 0 or var[y] == 0:
                out[i] = 1.0
                continue
            zcols = tuple(c for c in zs if var[c] > 0)
            groups.setdefault(len(zcols), []).append((i, x, y, zcols))

        fused_z, pair_stats = _get_batched()

        n = self.df.num_rows
        two_pi = 2 * np.pi
        for size, items in groups.items():
            dp = 1
            while dp < size:
                dp *= 2
            if size == 0:
                per_test = n * (4 * self.num_xy
                                + 2 * self.num_xy * self.num_xy)
            else:
                per_test = n * (dp + 6 * self.num_xy + 2 * self.num_z
                                + 2 * self.num_xy * self.num_xy)
            bmax = max(1, self._ELEM_BUDGET // per_test)
            # ONE launch shape per (n, dp): every chunk — including partial
            # tails — pads to the same pow2 b_chunk. Padded lanes waste a
            # little cheap compute, but each distinct shape costs a full
            # XLA compile, so a bounded shape set dominates any padding
            # waste.
            b_chunk = 1
            while b_chunk * 2 <= bmax:
                b_chunk *= 2
            dev, dpos = self._device_data()
            for start in range(0, len(items), b_chunk):
                chunk = items[start:start + b_chunk]
                real = len(chunk)
                bp = b_chunk
                padded = chunk + [chunk[-1]] * (bp - real)
                rng = self._rng
                xc = np.array([dpos[x] for (_, x, _, _) in padded],
                              np.int32)
                yc = np.array([dpos[y] for (_, _, y, _) in padded],
                              np.int32)
                sigx = np.array([
                    self._sigma1(x, data[x]) for (_, x, _, _) in padded
                ])
                sigy = np.array([
                    self._sigma1(y, data[y]) for (_, _, y, _) in padded
                ])
                Wx = (rng.standard_normal((bp, self.num_xy))
                      / sigx[:, None]).astype(np.float32)
                bx = rng.uniform(0, two_pi,
                                 (bp, self.num_xy)).astype(np.float32)
                Wy = (rng.standard_normal((bp, self.num_xy))
                      / sigy[:, None]).astype(np.float32)
                by = rng.uniform(0, two_pi,
                                 (bp, self.num_xy)).astype(np.float32)
                if size == 0:
                    ssq_d, eigs_d = pair_stats(dev, xc, Wx, bx, yc, Wy, by)
                    ssq, eigs = _pack_fetch(ssq_d, eigs_d)
                    sta = n * ssq
                    pv = chisq_sum_pvalues_batch(eigs[:real], sta[:real])
                    for j in range(real):
                        out[padded[j][0]] = pv[j]
                    continue
                zc = np.zeros((bp, dp), np.int32)
                zm = np.zeros((bp, dp), np.float32)
                sigz = np.empty(bp)
                for j, (_, _, _, zcols) in enumerate(padded):
                    zc[j, :size] = [dpos[c] for c in zcols]
                    zm[j, :size] = 1.0
                    zmat = np.column_stack([data[c] for c in zcols])
                    sigz[j] = self._sigmaz(zcols, zmat)
                Wz = (rng.standard_normal((bp, dp, self.num_z))
                      / sigz[:, None, None]).astype(np.float32)
                bz = rng.uniform(0, two_pi,
                                 (bp, self.num_z)).astype(np.float32)
                sta_d, eigs_d = fused_z(
                    dev, xc, Wx, bx, yc, Wy, by, zc, zm, Wz, bz
                )
                sta, eigs = _pack_fetch(sta_d, eigs_d)
                pv = chisq_sum_pvalues_batch(
                    eigs[:real], sta[:real], force_hbe=self.num_z == 1
                )
                for j in range(real):
                    out[padded[j][0]] = pv[j]
        return out


class DynamicRCoT(DynamicIndependenceTest):
    test_cls = RCoT
