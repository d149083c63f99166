"""ctypes loader for the native discrete-family scoring core
(pybnesian_tpu/_native/discretecore.cpp, auto-built on first use like the
graph closure core). The reference scores discrete families in C++
(scores/bic.cpp:66-97 over discrete_indices.cpp counts); this is the
small/medium tier of the adaptive dispatch in learning/scores/bic.py —
one compiled pass over the cached codes for a whole hill-climbing batch.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

__all__ = ["available", "bic_batch", "bic_addcand", "hc_discrete", "chi2_batch", "gtest_batch", "grouped_moments", "bde_batch"]

_LIB = None
_TRIED = False

# beyond this configuration-space size the device scatter-count path wins
MAX_CONFIGS = 1 << 22


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    pkg_dir = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    src = os.path.join(pkg_dir, "_native", "discretecore.cpp")
    from ..._native import build_and_load

    lib = build_and_load(src)
    lib.dc_bic_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
    ]
    lib.dc_bic_batch.restype = None
    lib.dc_bic_addcand.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
    ]
    lib.dc_bic_addcand.restype = None
    lib.dc_hc.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.dc_bde_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.dc_bde_batch.restype = None
    lib.dc_hc.restype = ctypes.c_int32
    lib.dc_chi2_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.dc_chi2_batch.restype = None
    lib.dc_gtest_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.dc_gtest_batch.restype = None
    lib.dc_grouped_moments.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.dc_grouped_moments.restype = None
    _LIB = lib
    _TRIED = True
    return _LIB


def available() -> bool:
    return _load() is not None


def bic_batch(codes_block: np.ndarray, cards: np.ndarray,
              fam_var: np.ndarray, fam_parents: np.ndarray) -> np.ndarray:
    """BIC scores for F families over the (ncols, n) int32 code block.

    ``fam_parents`` is (F, maxp) with -1 padding. Returns (F,) scores with
    NaN where the family's configuration space exceeded MAX_CONFIGS (the
    caller routes those to another tier).
    """
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    F, maxp = fam_parents.shape
    out = np.empty(F, np.float64)
    lib.dc_bic_batch(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, ncols,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        np.ascontiguousarray(fam_var, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(fam_parents, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        F, maxp, MAX_CONFIGS,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def bic_addcand(codes_block: np.ndarray, cards: np.ndarray, tcol: int,
                base_idx: np.ndarray, cand_idx: np.ndarray) -> np.ndarray:
    """BIC scores of the families (tcol, base_idx + [c]) for every c in
    ``cand_idx`` — one shared-base counting pass (dc_bic_addcand). Counts
    and scores are identical to :func:`bic_batch` on the expanded family
    list; NaN marks config-space overflow or all-null families."""
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    base_idx = np.ascontiguousarray(base_idx, np.int32)
    cand_idx = np.ascontiguousarray(cand_idx, np.int32)
    out = np.empty(len(cand_idx), np.float64)
    lib.dc_bic_addcand(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        int(tcol),
        base_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(base_idx),
        cand_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(cand_idx),
        MAX_CONFIGS,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def hc_discrete(codes_block: np.ndarray, cards: np.ndarray,
                node_cols: np.ndarray, adj: np.ndarray, valid: np.ndarray,
                max_indegree: int, max_iters: int, epsilon: float,
                score_kind: int = 0, iss: float = 1.0):
    """Run the full discrete ArcOperatorSet hill-climbing natively
    (dc_hc; score_kind 0 = BIC, 1 = BDe with the given iss). Returns the
    (kind, s, t) op list, or None when the native loop aborts
    (config-space overflow — caller runs the generic path).
    kind: 0 AddArc(s, t), 1 RemoveArc(s, t), 2 FlipArc(s, t)."""
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    d = len(node_cols)
    node_cols = np.ascontiguousarray(node_cols, np.int32)
    adj = np.ascontiguousarray(adj, np.uint8)
    valid = np.ascontiguousarray(valid, np.uint8)
    max_ops = max(4 * d * d, 1024)
    out_ops = np.empty((max_ops, 3), np.int32)
    rc = lib.dc_hc(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        node_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        d,
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(max_indegree),
        int(max_iters),
        float(epsilon),
        MAX_CONFIGS,
        int(score_kind),
        float(iss),
        out_ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_ops,
    )
    if rc < 0:
        return None
    return out_ops[:rc]


def chi2_batch(codes_block: np.ndarray, cards: np.ndarray,
               tx: np.ndarray, ty: np.ndarray, tz: np.ndarray) -> np.ndarray:
    """Pearson χ² statistics for F conditional tests x ⊥ y | Z.
    ``tz`` is (F, maxz) with -1 padding. NaN marks config-space overflow
    (caller falls back to the serial path for that test)."""
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    F, maxz = tz.shape if tz.ndim == 2 else (len(tx), 0)
    if maxz == 0:
        tz = np.full((F, 1), -1, np.int32)
        maxz = 1
    out = np.empty(F, np.float64)
    lib.dc_chi2_batch(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        np.ascontiguousarray(tx, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(ty, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(tz, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        F, maxz, MAX_CONFIGS,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def gtest_batch(codes_block: np.ndarray, cards: np.ndarray,
                tx: np.ndarray, ty: np.ndarray, tz: np.ndarray):
    """(N·MI statistic, valid-row count) for F all-discrete conditional MI
    tests. NaN statistic marks config-space overflow."""
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    F, maxz = tz.shape
    out = np.empty(F, np.float64)
    out_n = np.empty(F, np.float64)
    lib.dc_gtest_batch(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        np.ascontiguousarray(tx, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(ty, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(tz, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        F, maxz, MAX_CONFIGS,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out, out_n


def grouped_moments(vals: np.ndarray, idx: np.ndarray, valid: np.ndarray,
                    n_configs: int):
    """Per-config (counts, sums, group-centred product sums) over valid
    rows in two fused native passes. vals: (n, d) float64 C-contiguous;
    idx: (n,) int64; valid: (n,) uint8/bool. Returns (counts (C,),
    sums (C, d), sq (C, d, d))."""
    lib = _load()
    assert lib is not None
    n, d = vals.shape
    vals = np.ascontiguousarray(vals, np.float64)
    idx = np.ascontiguousarray(idx, np.int64)
    valid = np.ascontiguousarray(valid, np.uint8)
    counts = np.empty(n_configs, np.int64)
    sums = np.empty((n_configs, d), np.float64)
    sq = np.empty((n_configs, d, d), np.float64)
    lib.dc_grouped_moments(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, d, n_configs,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sums.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return counts, sums, sq


def bde_batch(codes_block: np.ndarray, cards: np.ndarray,
              fam_var: np.ndarray, fam_parents: np.ndarray,
              iss: float) -> np.ndarray:
    """BDe local scores (uniform iss prior) for F families — same contract
    as :func:`bic_batch`; NaN marks config-space overflow."""
    lib = _load()
    assert lib is not None
    ncols, n = codes_block.shape
    F, maxp = fam_parents.shape
    out = np.empty(F, np.float64)
    lib.dc_bde_batch(
        codes_block.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, ncols,
        np.ascontiguousarray(cards, np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)
        ),
        np.ascontiguousarray(fam_var, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        np.ascontiguousarray(fam_parents, np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)
        ),
        F, maxp, MAX_CONFIGS, float(iss),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
