"""BASELINE config 4b (round 5): PC-stable over DISCRETE and HYBRID data —
the terrain of config 5's DMMHC-over-CLG — through the batched
independence tests (ChiSquare via discretecore dc_chi2_batch, hybrid
MutualInformation via dc_gtest_batch for its all-discrete case). The
reference applies one serial C++ test at a time (pc.cpp:222-263,
discrete/chi_square.cpp, hybrid/mutual_information.cpp:921-1033).

Prints ONE JSON line.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pybnesian_tpu.runtime.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

N_NODES = 25
N_ROWS = 50_000


def make_discrete(n=N_ROWS, d=N_NODES, seed=0):
    import pandas as pd

    rng = np.random.default_rng(seed)
    cols = {}
    prev = rng.integers(0, 3, n)
    for i in range(d):
        cur = np.where(rng.random(n) < 0.35, rng.integers(0, 3, n), prev)
        cols[f"v{i}"] = pd.Categorical.from_codes(cur, ["x", "y", "z"])
        prev = cur
    return pd.DataFrame(cols)


def make_hybrid(df, seed=1):
    rng = np.random.default_rng(seed)
    out = df.copy()
    n = len(df)
    for i in range(0, N_NODES, 5):  # every 5th node gets a continuous child
        codes = df[f"v{i}"].cat.codes.to_numpy()
        out[f"c{i}"] = (0.6 * codes + rng.normal(0, 1, n)).astype(np.float64)
    return out


class _Counting:
    def __init__(self, inner, batched=True):
        self.inner = inner
        self.count = 0
        if batched:
            self.pvalue_batch = self._pvalue_batch

    def pvalue(self, x, y, *z):
        self.count += 1
        return self.inner.pvalue(x, y, *z)

    def _pvalue_batch(self, triples):
        triples = list(triples)
        self.count += len(triples)
        return self.inner.pvalue_batch(triples)

    def variable_names(self):
        return self.inner.variable_names()

    def num_variables(self):
        return self.inner.num_variables()

    def name(self, i):
        return self.inner.name(i)

    def has_variables(self, v):
        return self.inner.has_variables(v)


def bench_pc(test, batched=True):
    from pybnesian_tpu import PC

    t = _Counting(test, batched=batched)
    t0 = time.time()
    g = PC().estimate(t, alpha=0.05)
    el = time.time() - t0
    return t.count / el, t.count, g.num_arcs() + g.num_edges()


def main():
    from pybnesian_tpu import ChiSquare, MutualInformation

    df = make_discrete()
    chi = ChiSquare(df)
    chi_rate, chi_tests, chi_links = bench_pc(chi)
    # serial baseline: the SAME full PC run with the per-test path (the
    # reference's uniform serial loop, pc.cpp:222-263)
    chi_serial, _, _ = bench_pc(chi, batched=False)

    hdf = make_hybrid(df.iloc[:20_000])
    mi = MutualInformation(hdf)
    mi_rate, mi_tests, mi_links = bench_pc(mi)
    mi_serial, _, _ = bench_pc(mi, batched=False)

    print(json.dumps({
        "metric": "config4b_discrete_pc_pvalues_per_s",
        "value": round(chi_rate, 1),
        "unit": (
            f"pvalues/s (PC + ChiSquare, {N_NODES} nodes, {N_ROWS} rows, "
            f"{chi_tests} tests, {chi_links} links)"
        ),
        "vs_baseline": round(chi_rate / chi_serial, 2),
        "vs_serial_chisquare_pc": round(chi_rate / chi_serial, 2),
        "hybrid_mi_pc_pvalues_per_s": round(mi_rate, 1),
        "hybrid_mi_tests": mi_tests,
        "vs_serial_hybrid_mi_pc": round(mi_rate / mi_serial, 2),
    }))


if __name__ == "__main__":
    main()
