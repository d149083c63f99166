"""Device kernels for Gaussian kernel density estimation.

Batched replacement for the reference's OpenCL KDE pipeline
(kde/opencl_kernels/KDE.cl.src: solve/square/logl_values/logsumexp kernels and
the ≤64-column tiling loop, opencl/opencl_config.hpp:344-536). The key
restructuring: whiten train/test once with a triangular solve, then the whole
N_train × M_test pair matrix is ONE matmul —
``‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b`` — followed by a fused logsumexp. Test rows
are processed in fixed-size chunks (lax.map) to bound memory, the same role
as the reference's 64-column loop. On a GPU the CV-scoring pass instead runs
the streaming Pallas kernel (:func:`ckde_cv_alldevice_flash`), which never
writes the pair matrix to device memory.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

LOG_2PI = math.log(2.0 * math.pi)
HIGHEST = jax.lax.Precision.HIGHEST


def _dot(a, b):
    """Matmuls on the KDE path need full float32 accuracy: the default
    precision lets XLA use reduced-precision passes (TF32 on a GPU, bf16
    passes on some CPUs), which destroys the ||a||^2+||b||^2-2ab
    cancellation exactly at the small distances that dominate the
    logsumexp, and perturbs the bandwidth and the whitening."""
    return jnp.dot(a, b, precision=HIGHEST, preferred_element_type=a.dtype)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def next_multiple(x: int, m: int) -> int:
    return cdiv(max(x, 1), m) * m


@partial(jax.jit, static_argnames=("chunk",))
def kde_logl_whitened(train_white, test_white, lognorm, chunk=1024):
    """Per-test-point KDE log-likelihood.

    train_white: (N, d) training points already multiplied by L⁻¹ (bandwidth
    Cholesky); test_white: (M, d) with M a multiple of ``chunk``;
    lognorm: scalar −Σ log diag(L) − d/2·log 2π − log N
    (reference kde/KDE.hpp:451-478).
    Returns (M,) log p(test).
    """
    d = train_white.shape[1]
    tn = jnp.sum(jnp.square(train_white), axis=1)

    def body(tc):
        cross = _dot(tc, train_white.T)
        d2 = jnp.sum(jnp.square(tc), axis=1)[:, None] - 2.0 * cross + tn[None, :]
        return jax.nn.logsumexp(-0.5 * d2, axis=1)

    chunks = test_white.reshape(-1, chunk, d)
    out = jax.lax.map(body, chunks).reshape(-1)
    return out + lognorm


@partial(jax.jit, static_argnames=("chunk",))
def kde_logl_pair(train_white, test_white, lognorm, chunk=1024):
    """Full (M, N) matrix of per-kernel log-densities (before logsumexp):
    logK[j, i] = −½‖test_j − train_i‖² + lognorm_per_kernel.
    Used by CKDE sampling weights (reference CKDE.hpp:289-470)."""
    d = train_white.shape[1]
    tn = jnp.sum(jnp.square(train_white), axis=1)

    def body(tc):
        cross = _dot(tc, train_white.T)
        d2 = jnp.sum(jnp.square(tc), axis=1)[:, None] - 2.0 * cross + tn[None, :]
        return -0.5 * d2

    chunks = test_white.reshape(-1, chunk, d)
    out = jax.lax.map(body, chunks).reshape(test_white.shape[0], -1)
    return out + lognorm


@partial(jax.jit, static_argnames=("chunk",))
def kde_conditional_logsumexp(
    joint_train_white,
    joint_test_white,
    marg_train_white,
    marg_test_white,
    joint_lognorm,
    marg_lognorm,
    chunk=1024,
):
    """CKDE logl = logsumexp_joint − logsumexp_marginal in one fused pass
    (reference CKDE.hpp:202-254 computes the two separately then subtracts on
    device). Shapes: joint (N, d+e)/(M, d+e), marg (N, e)/(M, e)."""
    dj = joint_train_white.shape[1]
    dm = marg_train_white.shape[1]
    jn = jnp.sum(jnp.square(joint_train_white), axis=1)
    mn = jnp.sum(jnp.square(marg_train_white), axis=1)

    def body(args):
        jc, mc = args
        jcross = _dot(jc, joint_train_white.T)
        jd2 = jnp.sum(jnp.square(jc), axis=1)[:, None] - 2.0 * jcross + jn[None, :]
        lj = jax.nn.logsumexp(-0.5 * jd2, axis=1)
        mcross = _dot(mc, marg_train_white.T)
        md2 = jnp.sum(jnp.square(mc), axis=1)[:, None] - 2.0 * mcross + mn[None, :]
        lm = jax.nn.logsumexp(-0.5 * md2, axis=1)
        return lj - lm

    jchunks = joint_test_white.reshape(-1, chunk, dj)
    mchunks = marg_test_white.reshape(-1, chunk, dm)
    out = jax.lax.map(body, (jchunks, mchunks)).reshape(-1)
    return out + (joint_lognorm - marg_lognorm)


@partial(jax.jit, static_argnames=("chunk",))
def batched_ckde_logl(jtr, jte, zv_tr, zv_te, trm, lndiff, chunk=256):
    """Per-test-row conditional-KDE log-likelihood of F factors in ONE
    device launch — the model-level ``logl`` path (reference
    BNGeneric::logl:996 sums factor logls one at a time; batching removes
    the per-node dispatch round trip).

    Shared-Cholesky layout (evidence first, variable last): jtr: (F, ntr,
    djmax) whitened joint train with padded rows masked by trm; jte: (F,
    nte, djmax); zv_tr/zv_te: (F, *) whitened variable coordinate so
    ``marg_d2 = joint_d2 − Δz_var²`` — one distance matmul serves both
    log-densities; trm: (F, ntr); lndiff: (F,) = joint_lognorm −
    marg_lognorm = −log L_vv − ½ log 2π (with −log n_valid as the marginal
    lognorm of evidence-free factors, whose Δz subtraction zeroes marg_d2
    and makes the marginal logsumexp log n_valid). Returns (F, nte)."""
    dj = jtr.shape[2]

    def one(jt, jw, zt, zw, m, a):
        jn = jnp.sum(jnp.square(jt), axis=1)
        neg = jnp.where(m > 0, 0.0, -jnp.inf)

        def body(args):
            jc, zc = args
            jd2 = (
                jnp.sum(jnp.square(jc), axis=1)[:, None]
                - 2.0 * _dot(jc, jt.T)
                + jn[None, :]
            )
            lj = jax.nn.logsumexp(-0.5 * jd2 + neg[None, :], axis=1)
            vdiff = zc[:, None] - zt[None, :]
            md2 = jd2 - vdiff * vdiff
            lm = jax.nn.logsumexp(-0.5 * md2 + neg[None, :], axis=1)
            return lj - lm

        jchunks = jw.reshape(-1, chunk, dj)
        zchunks = zw.reshape(-1, chunk)
        out = jax.lax.map(body, (jchunks, zchunks)).reshape(-1)
        return out + a

    return jax.vmap(one)(jtr, jte, zv_tr, zv_te, trm, lndiff)


@partial(jax.jit, static_argnames=("chunk",))
def ckde_cv_slogl(joint_tr, joint_te, marg_tr, marg_te, tr_mask, te_mask,
                  joint_ln, marg_ln, chunk=256):
    """k-fold CV test log-likelihood of one CKDE family, folds batched.

    joint_tr: (K, Ntr, dj) per-fold whitened training blocks (padded rows
    anywhere with tr_mask 0), joint_te: (K, Nte, dj) whitened test blocks,
    marg_*: same for the evidence marginal; tr_mask: (K, Ntr), te_mask:
    (K, Nte); joint_ln/marg_ln: (K,) lognorm constants. Nte must be a
    multiple of ``chunk``. Returns the scalar summed test logl."""
    dj = joint_tr.shape[2]
    dm = marg_tr.shape[2]

    def fold(jtr, jte, mtr, mte, trm, tem, jln, mln):
        jn = jnp.sum(jnp.square(jtr), axis=1)
        mn = jnp.sum(jnp.square(mtr), axis=1)
        neg = jnp.where(trm > 0, 0.0, -jnp.inf)

        def body(args):
            jc, mc = args
            jd2 = (
                jnp.sum(jnp.square(jc), axis=1)[:, None]
                - 2.0 * _dot(jc, jtr.T)
                + jn[None, :]
            )
            lj = jax.nn.logsumexp(-0.5 * jd2 + neg[None, :], axis=1)
            md2 = (
                jnp.sum(jnp.square(mc), axis=1)[:, None]
                - 2.0 * _dot(mc, mtr.T)
                + mn[None, :]
            )
            lm = jax.nn.logsumexp(-0.5 * md2 + neg[None, :], axis=1)
            return lj - lm

        jchunks = jte.reshape(-1, chunk, dj)
        mchunks = mte.reshape(-1, chunk, dm)
        out = jax.lax.map(body, (jchunks, mchunks)).reshape(-1)
        return jnp.sum((out + (jln - mln)) * tem)

    return jnp.sum(jax.vmap(fold)(joint_tr, joint_te, marg_tr, marg_te,
                                  tr_mask, te_mask, joint_ln, marg_ln))


@partial(jax.jit, static_argnames=("chunk", "rule"))
def ckde_cv_alldevice(data, null_mask, col_idx, col_mask, tr_idx, tr_mask,
                      te_idx, te_mask, chunk=256, rule="nr"):
    """Fully-fused CV-likelihood of F CKDE families: ONE device launch does
    the per-fold row gather, rule-based bandwidth (normal-reference or
    Scott), Cholesky, whitening and the pairwise logsumexp. The host only
    uploads the data matrix once per score instance and per-batch family
    column indices — the end-state of the SURVEY §7 "upload once" design.

    Family columns are laid out EVIDENCE FIRST with the variable at position
    ``d_eff - 1``. Because the Cholesky factor of the joint bandwidth is
    lower-triangular, its leading (evidence × evidence) block *is* the
    marginal's Cholesky factor (the same sharing the reference exploits with
    sub-range device buffers, CKDE.hpp:182-200). Hence one Cholesky, one
    whitening and ONE pairwise-distance matmul serve both log-densities:
    ``marg_d2 = joint_d2 − Δz_var²`` where ``z_var`` is the whitened variable
    coordinate — halving the pre-exp work and HBM traffic of the kernel.

    data: (n, D) values (nulls zeroed); null_mask: (n, D) 1.0 where null;
    col_idx/col_mask: (F, djmax) family columns, evidence first / variable
    last; tr_idx/tr_mask: (K, ntr) fold train rows (shared across families);
    te_idx/te_mask: (K, nte). Returns (F,) summed CV test logl; NaN marks
    degenerate families (caller maps to -inf).
    """
    djmax = col_idx.shape[1]
    eye = jnp.eye(djmax, dtype=data.dtype)

    def family(cidx, cmask):
        fam = data[:, cidx] * cmask[None, :]
        fam_null = jnp.max(null_mask[:, cidx] * cmask[None, :], axis=1)
        fvalid = 1.0 - fam_null
        d_eff = jnp.sum(cmask)
        # one-hot of the variable position (= last valid column)
        dim_ids = jnp.arange(djmax, dtype=cmask.dtype)
        vsel = jnp.where(dim_ids == d_eff - 1.0, 1.0, 0.0) * cmask
        mmask = cmask - vsel

        def fold(tri, trm, tei, tem):
            w = trm * fvalid[tri]
            train = fam[tri]
            n_eff = jnp.sum(w)
            mean = jnp.sum(train * w[:, None], axis=0) / n_eff
            xc = (train - mean[None, :]) * (w[:, None] * cmask[None, :])
            cov = jnp.einsum(
                "ni,nj->ij", xc, xc, precision=HIGHEST,
                preferred_element_type=data.dtype,
            ) / (n_eff - 1.0)
            if rule == "nr":
                k = (4.0 / (n_eff * (d_eff + 2.0))) ** (2.0 / (d_eff + 4.0))
            else:  # scott
                k = n_eff ** (-2.0 / (d_eff + 4.0))
            H = k * cov + jnp.diag(1.0 - cmask)
            L = jnp.linalg.cholesky(H)
            Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
            logdiag = jnp.log(jnp.abs(jnp.diag(L)))
            jln = (
                -jnp.sum(logdiag * cmask)
                - 0.5 * d_eff * LOG_2PI
                - jnp.log(n_eff)
            )
            # marginal lognorm: diag(chol(H_marg)) = leading diag of L
            mln = (
                -jnp.sum(logdiag * mmask)
                - 0.5 * (d_eff - 1.0) * LOG_2PI
                - jnp.log(n_eff)
            )
            jtr = _dot(train, Linv.T)
            test = fam[tei]
            wte = tem * fvalid[tei]
            jte = _dot(test, Linv.T)
            # whitened variable coordinate (marg_d2 = joint_d2 − Δz_var²)
            zv_tr = _dot(jtr, vsel)
            zv_te = _dot(jte, vsel)
            neg = jnp.where(w > 0, 0.0, -jnp.inf)
            jn = jnp.sum(jnp.square(jtr), axis=1)

            def body(args):
                jc, zc = args
                jd2 = (
                    jnp.sum(jnp.square(jc), axis=1)[:, None]
                    - 2.0 * _dot(jc, jtr.T)
                    + jn[None, :]
                )
                lj = jax.nn.logsumexp(-0.5 * jd2 + neg[None, :], axis=1)
                vdiff = zc[:, None] - zv_tr[None, :]
                md2 = jd2 - vdiff * vdiff
                lm = jax.nn.logsumexp(-0.5 * md2 + neg[None, :], axis=1)
                return lj - lm

            jchunks = jte.reshape(-1, chunk, djmax)
            zchunks = zv_te.reshape(-1, chunk)
            out = jax.lax.map(body, (jchunks, zchunks)).reshape(-1)
            fold_ll = jnp.sum((out + (jln - mln)) * wte)
            # degenerate folds (n_eff too small / singular chol) -> NaN
            return jnp.where(n_eff > d_eff, fold_ll, jnp.nan)

        return jnp.sum(jax.vmap(fold)(tr_idx, tr_mask, te_idx, te_mask))

    return jax.vmap(family)(col_idx, col_mask)


@partial(jax.jit, static_argnames=("rule",))
def ckde_cv_whitened_parts(data, null_mask, col_idx, col_mask, tr_idx,
                           tr_mask, te_idx, te_mask, rule="nr"):
    """Stage 1 of the flash CV-CKDE path: per (family, fold) gather, rule
    bandwidth, Cholesky and whitening — everything *before* the pairwise
    part. Same family-column convention as :func:`ckde_cv_alldevice`
    (evidence first, variable last). Returns
    ``(jtr, neg, zv_tr, jte, zv_te, wte, lndiff, ok)`` with leading (F, K)
    axes; the pairwise logl can then run in a Pallas kernel that never
    materializes the (nte × ntr) matrix in HBM."""
    djmax = col_idx.shape[1]
    eye = jnp.eye(djmax, dtype=data.dtype)

    def family(cidx, cmask):
        fam = data[:, cidx] * cmask[None, :]
        fam_null = jnp.max(null_mask[:, cidx] * cmask[None, :], axis=1)
        fvalid = 1.0 - fam_null
        d_eff = jnp.sum(cmask)
        dim_ids = jnp.arange(djmax, dtype=cmask.dtype)
        vsel = jnp.where(dim_ids == d_eff - 1.0, 1.0, 0.0) * cmask
        mmask = cmask - vsel

        def fold(tri, trm, tei, tem):
            w = trm * fvalid[tri]
            train = fam[tri]
            n_eff = jnp.sum(w)
            mean = jnp.sum(train * w[:, None], axis=0) / n_eff
            xc = (train - mean[None, :]) * (w[:, None] * cmask[None, :])
            cov = jnp.einsum(
                "ni,nj->ij", xc, xc, precision=HIGHEST,
                preferred_element_type=data.dtype,
            ) / (n_eff - 1.0)
            if rule == "nr":
                k = (4.0 / (n_eff * (d_eff + 2.0))) ** (2.0 / (d_eff + 4.0))
            else:  # scott
                k = n_eff ** (-2.0 / (d_eff + 4.0))
            H = k * cov + jnp.diag(1.0 - cmask)
            L = jnp.linalg.cholesky(H)
            Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
            logdiag = jnp.log(jnp.abs(jnp.diag(L)))
            # lndiff = jln − mln = −log|L_vv| − ½ log 2π (n_eff terms cancel)
            lndiff = -jnp.sum(logdiag * vsel) - 0.5 * LOG_2PI
            jtr = _dot(train, Linv.T)
            jte = _dot(fam[tei], Linv.T)
            zv_tr = _dot(jtr, vsel)
            zv_te = _dot(jte, vsel)
            neg = jnp.where(w > 0, 0.0, -jnp.inf)
            wte = tem * fvalid[tei]
            ok = (n_eff > d_eff).astype(data.dtype)
            return jtr, neg, zv_tr, jte, zv_te, wte, lndiff, ok

        return jax.vmap(fold)(tr_idx, tr_mask, te_idx, te_mask)

    return jax.vmap(family)(col_idx, col_mask)


def cv_pairs_route(platform: str, dtype) -> str:
    """Which kernel runs the CV-CKDE pairwise pass: ``"triton"`` (the
    streaming Pallas kernel, :func:`ckde_cv_alldevice_flash`) for float32
    data on a GPU, ``"xla"`` (:func:`ckde_cv_alldevice`) everywhere else."""
    if platform == "gpu" and jnp.dtype(dtype) == jnp.float32:
        return "triton"
    return "xla"


@partial(jax.jit, static_argnames=("rule", "block_m", "block_n",
                                   "interpret"))
def ckde_cv_alldevice_flash(data, null_mask, col_idx, col_mask, tr_idx,
                            tr_mask, te_idx, te_mask, rule="nr",
                            block_m: int = 32, block_n: int = 128,
                            interpret: bool = False):
    """Streaming variant of :func:`ckde_cv_alldevice`: whitening in XLA
    (:func:`ckde_cv_whitened_parts`), then the pairwise double logsumexp in
    the Pallas kernel :func:`pybnesian_tpu.ops.pallas_kde.
    pallas_ckde_cv_pairs`, which never writes the (nte × ntr) logits to
    device memory. Same arguments and result as :func:`ckde_cv_alldevice`;
    float32 only. Train rows are padded to a multiple of ``block_n``, test
    rows to a multiple of ``block_m`` and the column count to a power of
    two (at least 2)."""
    from .pallas_kde import pallas_ckde_cv_pairs

    jtr, neg, zv_tr, jte, zv_te, wte, lndiff, ok = ckde_cv_whitened_parts(
        data, null_mask, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask,
        rule=rule,
    )
    F, K, ntr, dj = jtr.shape
    nte = jte.shape[2]
    pad_n = next_multiple(ntr, block_n) - ntr
    pad_m = next_multiple(nte, block_m) - nte
    pad_d = max(2, 1 << (dj - 1).bit_length()) - dj
    jtr = jnp.pad(jtr, ((0, 0), (0, 0), (0, pad_n), (0, pad_d)))
    neg = jnp.pad(neg, ((0, 0), (0, 0), (0, pad_n)),
                  constant_values=-jnp.inf)
    zv_tr = jnp.pad(zv_tr, ((0, 0), (0, 0), (0, pad_n)))
    jte = jnp.pad(jte, ((0, 0), (0, 0), (0, pad_m), (0, pad_d)))
    zv_te = jnp.pad(zv_te, ((0, 0), (0, 0), (0, pad_m)))
    dpad = dj + pad_d
    # evidence-free families: the marginal logsumexp is exactly log n_eff —
    # flag them so the kernel skips the whole marginal pass
    no_ev = jnp.broadcast_to(
        (jnp.sum(col_mask, axis=1) <= 1.0)[:, None], (F, K)
    )
    n_eff = jnp.sum((neg == 0.0).astype(jnp.float32), axis=2)  # (F, K)
    lm_const = jnp.log(jnp.maximum(n_eff, 1.0))
    G = F * K
    out = pallas_ckde_cv_pairs(
        jtr.reshape(G, -1, dpad).astype(jnp.float32),
        neg.reshape(G, -1).astype(jnp.float32),
        zv_tr.reshape(G, -1).astype(jnp.float32),
        jte.reshape(G, -1, dpad).astype(jnp.float32),
        zv_te.reshape(G, -1).astype(jnp.float32),
        no_ev.reshape(G),
        lm_const.reshape(G),
        block_m=block_m, block_n=block_n, interpret=interpret,
    ).reshape(F, K, -1)[:, :, :nte]
    out = jnp.where(wte > 0, out, 0.0)
    fold_ll = jnp.sum(out * wte, axis=2) + lndiff * jnp.sum(wte, axis=2)
    fold_ll = jnp.where(ok > 0, fold_ll, jnp.nan)
    return jnp.sum(fold_ll, axis=1)


@partial(jax.jit, static_argnames=("chunk",))
def batched_ckde_cv_slogl(joint_tr, joint_te, marg_tr, marg_te, tr_mask,
                          te_mask, joint_ln, marg_ln, chunk=256):
    """F CKDE families × K folds in ONE device call — the structure-search
    hot path batched over candidate families (leading F axis on every
    argument)."""

    def one(jtr, jte, mtr, mte, trm, tem, jln, mln):
        return ckde_cv_slogl(jtr, jte, mtr, mte, trm, tem, jln, mln,
                             chunk=chunk)

    return jax.vmap(one)(joint_tr, joint_te, marg_tr, marg_te, tr_mask,
                         te_mask, joint_ln, marg_ln)


@partial(jax.jit, static_argnames=("chunk",))
def batched_kde_cv_slogl(tr, te, tr_mask, te_mask, ln, chunk=256):
    """F (joint-only) KDE families × K folds in one call."""

    def one(xtr, xte, trm, tem, fln):
        return kde_cv_slogl(xtr, xte, trm, tem, fln, chunk=chunk)

    return jax.vmap(one)(tr, te, tr_mask, te_mask, ln)


@partial(jax.jit, static_argnames=("chunk",))
def kde_cv_slogl(tr, te, tr_mask, te_mask, ln, chunk=256):
    """k-fold CV test log-likelihood of one (joint-only) KDE family —
    the no-evidence CKDE case."""
    d = tr.shape[2]

    def fold(xtr, xte, trm, tem, fln):
        tn = jnp.sum(jnp.square(xtr), axis=1)
        neg = jnp.where(trm > 0, 0.0, -jnp.inf)

        def body(tc):
            d2 = (
                jnp.sum(jnp.square(tc), axis=1)[:, None]
                - 2.0 * _dot(tc, xtr.T)
                + tn[None, :]
            )
            return jax.nn.logsumexp(-0.5 * d2 + neg[None, :], axis=1)

        out = jax.lax.map(body, xte.reshape(-1, chunk, d)).reshape(-1)
        return jnp.sum((out + fln) * tem)

    return jnp.sum(jax.vmap(fold)(tr, te, tr_mask, te_mask, ln))


@partial(jax.jit, static_argnames=("chunk",))
def ucv_pair_sums(train_white, valid, chunk=512):
    """(Σ_{i<j} exp(−¼‖wᵢ−wⱼ‖²), Σ_{i<j} exp(−½‖wᵢ−wⱼ‖²)) over the pair
    triangle of whitened training points — the UCV leave-one-out terms for
    bandwidths 2H and H from ONE pairwise-distance computation (the reference
    computes the triangle with dedicated sum_ucv kernels, kde/UCV.cpp and
    KDE.cl.src:471-565). train_white: (Npad, d) with rows padded;
    valid: (Npad,) 0/1.

    The kernel is at the f32 exp roofline (docs/PERFORMANCE.md), so the
    only real lever is evaluating FEWER exps: the block sweep walks only
    the upper-triangle (ci ≤ cj) chunk pairs — ~2× fewer transcendentals
    than a full (chunk × Npad) rectangle per chunk, with the i ≥ j half of
    diagonal blocks as the only waste."""
    d = train_white.shape[1]
    npad = train_white.shape[0]
    row_ids = jnp.arange(npad)
    n_chunks = npad // chunk
    ci = []
    cj = []
    for a in range(n_chunks):
        for b in range(a, n_chunks):
            ci.append(a)
            cj.append(b)
    ci = jnp.asarray(ci, jnp.int32)
    cj = jnp.asarray(cj, jnp.int32)

    def body(args):
        a, b = args
        za = jnp.zeros((), a.dtype)
        ta = jax.lax.dynamic_slice(train_white, (a * chunk, za), (chunk, d))
        tb = jax.lax.dynamic_slice(train_white, (b * chunk, za), (chunk, d))
        ia = jax.lax.dynamic_slice(row_ids, (a * chunk,), (chunk,))
        ib = jax.lax.dynamic_slice(row_ids, (b * chunk,), (chunk,))
        va = jax.lax.dynamic_slice(valid, (a * chunk,), (chunk,))
        vb = jax.lax.dynamic_slice(valid, (b * chunk,), (chunk,))
        cross = _dot(ta, tb.T)
        d2 = (
            jnp.sum(jnp.square(ta), axis=1)[:, None]
            - 2.0 * cross
            + jnp.sum(jnp.square(tb), axis=1)[None, :]
        )
        pair_mask = (ia[:, None] < ib[None, :]) & (va[:, None] > 0) & (
            vb[None, :] > 0
        )
        # one transcendental per pair: exp(-1/2 d2) = exp(-1/4 d2)^2
        e = jnp.where(pair_mask, jnp.exp(-0.25 * d2), 0.0)
        return jnp.sum(e), jnp.sum(e * e)

    s2h, sh = jax.lax.map(body, (ci, cj))
    return jnp.sum(s2h), jnp.sum(sh)


@jax.jit
def gumbel_categorical(key, logits):
    """Row-wise categorical sample via Gumbel-max — the replacement for
    the reference's prefix-sum inverse-CDF kernels
    (accum_sum_mat_cols / find_random_indices, KDE.cl.src:253-375)."""
    g = jax.random.gumbel(key, logits.shape, logits.dtype)
    return jnp.argmax(logits + g, axis=1)
