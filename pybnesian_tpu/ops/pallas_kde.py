"""Pallas kernel (Triton route) for the CV-CKDE pairwise double logsumexp.

Streaming logsumexp: one program owns ``block_m`` test points of one
(family, fold) pair and walks the train points in tiles of ``block_n``,
keeping the maxima and exp-sums of the joint and of the evidence marginal in
registers. The (nte × ntr) pair matrix never exists in device memory, where
the XLA path (:func:`pybnesian_tpu.ops.kde.ckde_cv_alldevice`) writes it
once per test chunk and reads it back for the max and the exp-sum passes.

With d ≤ 8 whitened coordinates the squared distance is d FMAs per pair on
the CUDA cores (the contraction is far below the tensor cores' smallest K),
so the kernel is bound by the exps and the FMAs around them. Train data is
stored coordinate-major, (G, dpad, ntr): each coordinate of a train tile is
one coalesced vector load. On an H100 (400 W limit) it takes 4.2 ms per
config-3 batch against 12.0 ms for the XLA kernel (PERF.md).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["pallas_ckde_cv_pairs"]

#: finite "−inf" for the running max: keeps all-padding tiles NaN-free
_NEG_INIT = -1e30
#: inputs are pre-scaled by sqrt(½·log2 e), so the kernel works in base 2
#: (``exp2`` lowers to the hardware ex2 instruction) with no per-pair scale
_SCALE = math.sqrt(0.5 * math.log2(math.e))


def _ckde_cv_kernel(flag_ref, lmc_ref, tr_ref, neg_ref, zvtr_ref, te_ref,
                    zvte_ref, out_ref, *, block_n: int, dpad: int):
    """One program: ``block_m`` test points of one (family, fold) pair
    against every train tile, in base 2. The marginal logits come from the
    joint's for 3 flops: ``marg = joint + Δz_var²`` (the shared-Cholesky
    layout of :func:`pybnesian_tpu.ops.kde.ckde_cv_whitened_parts`).

    Two sweeps over the train tiles: the first keeps elementwise tile
    maxima, reduced to row maxima once at the end; the second accumulates
    ``exp2(logit − row max)`` elementwise, again reduced once. Neither sweep
    reduces across threads per tile, which a one-sweep online (max, sum)
    has to; on an H100 the two sweeps ran 2.1× faster than one."""
    n_blocks = tr_ref.shape[1] // block_n
    te = [te_ref[c, :] for c in range(dpad)]      # dpad × (block_m,)
    zte = zvte_ref[:]                             # (block_m,)
    block_m = zte.shape[0]
    g = pl.program_id(0)
    # evidence-free family: the marginal logsumexp is the constant
    # log n_eff, so the whole marginal pass is skipped
    no_ev = flag_ref[g] > 0.5

    def logits(nb, marginal):
        sl = pl.ds(nb * block_n, block_n)
        d2 = jnp.zeros((block_m, block_n), jnp.float32)
        for c in range(dpad):
            diff = te[c][:, None] - tr_ref[c, sl][None, :]
            d2 = d2 + diff * diff
        lj = neg_ref[sl][None, :] - d2
        if not marginal:
            return (lj,)
        vd = zte[:, None] - zvtr_ref[sl][None, :]
        return lj, lj + vd * vd

    def lse(marginal):
        k = 2 if marginal else 1
        tile0 = jnp.full((block_m, block_n), _NEG_INIT, jnp.float32)
        zero = jnp.zeros((block_m, block_n), jnp.float32)

        def maxes(nb, ms):
            return tuple(jnp.maximum(m, l)
                         for m, l in zip(ms, logits(nb, marginal)))

        ms = jax.lax.fori_loop(0, n_blocks, maxes, (tile0,) * k)
        ms = tuple(jnp.max(m, axis=1) for m in ms)

        def sums(nb, ss):
            return tuple(s + jnp.exp2(l - m[:, None]) for s, l, m in
                         zip(ss, logits(nb, marginal), ms))

        ss = jax.lax.fori_loop(0, n_blocks, sums, (zero,) * k)
        return [m + jnp.log2(jnp.sum(s, axis=1)) for m, s in zip(ms, ss)]

    def with_marginal():
        lj, lm = lse(True)
        return lj - lm

    def without_marginal():
        (lj,) = lse(False)
        return lj - lmc_ref[g]

    out_ref[:] = math.log(2.0) * jax.lax.cond(no_ev, without_marginal,
                                              with_marginal)


#: Warps per program of :func:`pallas_ckde_cv_pairs`.
NUM_WARPS = 4


@partial(jax.jit, static_argnames=("block_m", "block_n", "interpret"))
def pallas_ckde_cv_pairs(jtr, neg, zv_tr, jte, zv_te, no_ev, lm_const,
                         block_m: int = 32, block_n: int = 128,
                         interpret: bool = False):
    """(G, nte) per-test-point ``logsumexp_joint − logsumexp_marg`` (without
    lognorm constants) for G = F·K (family, fold) pairs, all float32.

    jtr: (G, ntr, dpad) whitened train with ntr a multiple of ``block_n``;
    neg: (G, ntr) 0 for valid train rows, −inf for padding; zv_tr: (G, ntr)
    whitened variable coordinate; jte: (G, nte, dpad) with nte a multiple
    of ``block_m``; zv_te: (G, nte). ``no_ev`` (G,) flags evidence-free
    families, whose marginal logsumexp is the constant ``lm_const[g]``
    (= log n_eff). ``dpad``, ``block_m`` and ``block_n`` are powers of two;
    the defaults and :data:`NUM_WARPS` were the fastest of a sweep on an
    H100 (PERF.md)."""
    G, ntr, dpad = jtr.shape
    nte = jte.shape[1]
    kernel = partial(_ckde_cv_kernel, block_n=block_n, dpad=dpad)
    return pl.pallas_call(
        kernel,
        grid=(G, nte // block_m),
        in_specs=[
            pl.BlockSpec((G,), lambda g, i: (0,)),
            pl.BlockSpec((G,), lambda g, i: (0,)),
            pl.BlockSpec((None, dpad, ntr), lambda g, i: (g, 0, 0)),
            pl.BlockSpec((None, ntr), lambda g, i: (g, 0)),
            pl.BlockSpec((None, ntr), lambda g, i: (g, 0)),
            pl.BlockSpec((None, dpad, block_m), lambda g, i: (g, 0, i)),
            pl.BlockSpec((None, block_m), lambda g, i: (g, i)),
        ],
        out_specs=pl.BlockSpec((None, block_m), lambda g, i: (g, i)),
        out_shape=jax.ShapeDtypeStruct((G, nte), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="ckde_cv_pairs",
    )(
        no_ev.astype(jnp.float32),
        lm_const.astype(jnp.float32) / math.log(2.0),
        jnp.swapaxes(jtr, 1, 2) * _SCALE,
        neg,
        zv_tr * _SCALE,
        jnp.swapaxes(jte, 1, 2) * _SCALE,
        zv_te * _SCALE,
    )
