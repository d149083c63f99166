"""Batched independence-test protocol (``pvalue_batch``) + batched PC.

The reference evaluates independence tests one at a time inside PC
(pc.cpp:92-263); the batched rebuild collects each sweep's candidates and
evaluates them per launch. These tests pin (a) exact serial/batch agreement
for deterministic tests, (b) the first-passing-candidate semantics of the
round-robin search, and (c) end-to-end PC equivalence between the batched
and serial code paths.
"""

import numpy as np
import pandas as pd
import pytest

from pybnesian_tpu import PC, ChiSquare, LinearCorrelation, RCoT
from pybnesian_tpu.learning.algorithms.pc import _batched_sepset_search
from data_gen import normal_chain_data


def _triples():
    return [
        ("a", "b", ()),
        ("a", "d", ()),
        ("a", "d", ("c",)),
        ("a", "c", ("b",)),
        ("a", "d", ("b", "c")),
        ("b", "d", ("c",)),
    ]


def test_linearcorrelation_batch_matches_serial_exactly():
    df = normal_chain_data(3000)
    lc = LinearCorrelation(df)
    batch = lc.pvalue_batch(_triples())
    serial = np.array([lc.pvalue(x, y, *z) for (x, y, z) in _triples()])
    np.testing.assert_allclose(batch, serial, rtol=1e-12, atol=0)


def test_linearcorrelation_batch_with_nulls_falls_back():
    df = normal_chain_data(2000)
    df.loc[3, "a"] = np.nan
    lc = LinearCorrelation(df)
    assert not lc._cached
    batch = lc.pvalue_batch(_triples())
    serial = np.array([lc.pvalue(x, y, *z) for (x, y, z) in _triples()])
    np.testing.assert_allclose(batch, serial, rtol=1e-12, atol=0)


def test_default_pvalue_batch_is_serial_loop():
    from data_gen import discrete_data

    cs_df = discrete_data(2000)
    t = ChiSquare(cs_df)
    batch = t.pvalue_batch([("A", "B", ()), ("A", "D", ("C",))])
    np.testing.assert_allclose(
        batch, [t.pvalue("A", "B"), t.pvalue("A", "D", "C")]
    )


class _ScriptedTest:
    """p-values looked up from a dict keyed by (x, y, zs); records the
    evaluation order."""

    def __init__(self, table, default=0.0):
        self.table = table
        self.default = default
        self.calls = []

    def pvalue_batch(self, triples):
        out = []
        for (x, y, zs) in triples:
            self.calls.append((x, y, tuple(zs)))
            out.append(self.table.get((x, y, tuple(zs)), self.default))
        return np.array(out)


def test_batched_sepset_search_takes_first_passing_candidate():
    # edge (u, v): candidates c1 (fails), c2 (passes), c3 (passes) — the
    # recorded sepset must be c2, exactly as the serial early-exit loop.
    table = {("u", "v", ("c2",)): 0.9, ("u", "v", ("c3",)): 0.95}
    t = _ScriptedTest(table)
    iters = {("u", "v"): iter([("c1",), ("c2",), ("c3",)])}
    resolved = _batched_sepset_search(iters, t, alpha=0.05)
    assert resolved == {("u", "v"): ({"c2"}, 0.9)}


def test_batched_sepset_search_survivor_and_multiple_edges():
    table = {("a", "b", ("z2",)): 0.8}
    t = _ScriptedTest(table)
    iters = {
        ("a", "b"): iter([("z1",), ("z2",)]),
        ("c", "d"): iter([("z1",), ("z2",), ("z3",)]),
    }
    resolved = _batched_sepset_search(iters, t, alpha=0.05)
    assert set(resolved) == {("a", "b")}
    assert resolved[("a", "b")] == ({"z2"}, 0.8)
    # the survivor's candidates were all evaluated
    assert ("c", "d", ("z3",)) in t.calls


class _SerialOnly:
    """Duck-typed wrapper WITHOUT pvalue_batch — forces PC down the serial
    fallback path."""

    def __init__(self, inner):
        self.inner = inner

    def pvalue(self, *a):
        return self.inner.pvalue(*a)

    def variable_names(self):
        return self.inner.variable_names()

    def num_variables(self):
        return self.inner.num_variables()

    def name(self, i):
        return self.inner.name(i)

    def has_variables(self, v):
        return self.inner.has_variables(v)


@pytest.mark.parametrize("use_sepsets", [False, True])
def test_pc_batched_equals_serial_path(use_sepsets):
    df = normal_chain_data(4000)
    lc = LinearCorrelation(df)
    g1 = PC().estimate(lc, alpha=0.05, use_sepsets=use_sepsets)
    g2 = PC().estimate(_SerialOnly(lc), alpha=0.05,
                       use_sepsets=use_sepsets)
    assert set(g1.arcs()) == set(g2.arcs())
    assert {frozenset(e) for e in g1.edges()} == {
        frozenset(e) for e in g2.edges()
    }


def test_rcot_batch_decisions_match_serial():
    rng = np.random.default_rng(7)
    n = 4000
    a = rng.normal(0, 1, n)
    b = 0.9 * a + rng.normal(0, 0.8, n)
    c = 0.9 * b + rng.normal(0, 0.8, n)
    df = pd.DataFrame({"a": a, "b": b, "c": c})
    t = RCoT(df, seed=0)
    ps = t.pvalue_batch([
        ("a", "b", ()),          # strongly dependent
        ("a", "c", ()),          # marginally dependent
        ("a", "c", ("b",)),      # independent given b
    ])
    assert ps.shape == (3,)
    assert np.all((ps >= 0) & (ps <= 1))
    assert ps[0] < 0.01
    assert ps[1] < 0.01
    assert ps[2] > 0.05


def test_rcot_batch_mixed_sizes_and_constant_columns():
    rng = np.random.default_rng(3)
    n = 1200
    df = pd.DataFrame({
        "x": rng.normal(0, 1, n),
        "y": rng.normal(0, 1, n),
        "z": rng.normal(0, 1, n),
        "w": rng.normal(0, 1, n),
    })
    t = RCoT(df, seed=0)
    ps = t.pvalue_batch([
        ("x", "y", ()),
        ("x", "y", ("z",)),
        ("x", "y", ("z", "w")),
    ])
    assert ps.shape == (3,)
    assert np.all(ps > 0.001)  # independent data: no tiny p-values


def test_rcot_batch_nulls_fall_back_to_serial():
    rng = np.random.default_rng(5)
    n = 800
    df = pd.DataFrame({
        "x": rng.normal(0, 1, n),
        "y": rng.normal(0, 1, n),
        "z": rng.normal(0, 1, n),
    })
    df.loc[5, "x"] = np.nan
    t = RCoT(df, seed=0)
    ps = t.pvalue_batch([("x", "y", ()), ("x", "y", ("z",))])
    assert ps.shape == (2,)
    assert np.all((ps >= 0) & (ps <= 1))


def test_pc_rcot_end_to_end_recovers_chain():
    rng = np.random.default_rng(11)
    n = 4000
    a = rng.normal(0, 1, n)
    b = 0.8 * a + rng.normal(0, 1, n)
    c = 0.7 * b + rng.normal(0, 1, n)
    d = 0.9 * c + rng.normal(0, 1, n)
    df = pd.DataFrame({"a": a, "b": b, "c": c, "d": d})
    g = PC().estimate(RCoT(df, seed=2), alpha=0.05)
    skeleton = {frozenset(e) for e in g.edges()} | {
        frozenset(a_) for a_ in g.arcs()
    }
    assert frozenset(("a", "b")) in skeleton
    assert frozenset(("b", "c")) in skeleton
    assert frozenset(("c", "d")) in skeleton
    assert frozenset(("a", "d")) not in skeleton


def test_pc_verbose_progress_smoke(capsys):
    df = normal_chain_data(1500)
    PC().estimate(LinearCorrelation(df), alpha=0.05, verbose=1)
    err = capsys.readouterr().err
    assert "No. sepset 0" in err
    assert "Finished PC skeleton" in err


def test_mmpc_verbose_progress_smoke(capsys):
    from pybnesian_tpu import MMPC

    df = normal_chain_data(1200)
    MMPC().estimate(LinearCorrelation(df), alpha=0.05, verbose=1)
    err = capsys.readouterr().err
    assert "MMPC" in err
    assert "Finished MMPC" in err


def test_mmpc_batched_equals_serial_path():
    from pybnesian_tpu import MMPC

    df = normal_chain_data(3000)
    lc = LinearCorrelation(df)
    g1 = MMPC().estimate(lc, alpha=0.05)
    g2 = MMPC().estimate(_SerialOnly(lc), alpha=0.05)
    assert set(g1.arcs()) == set(g2.arcs())
    assert {frozenset(e) for e in g1.edges()} == {
        frozenset(e) for e in g2.edges()
    }


def test_batched_assoc_sweep_exact_max_for_survivors():
    from pybnesian_tpu.learning.algorithms.pc import _batched_assoc_sweep

    table = {
        ("x", "y", ("a",)): 0.01,
        ("x", "y", ("b",)): 0.04,   # max for survivor (x, y)
        ("x", "z", ("a",)): 0.2,    # drops (x, z) at first candidate
    }
    t = _ScriptedTest(table, default=0.001)
    vals = _batched_assoc_sweep(
        {("x", "y"): iter([("a",), ("b",), ("c",)]),
         ("x", "z"): iter([("a",), ("b",)])},
        t, alpha=0.05,
        init={("x", "y"): 0.0, ("x", "z"): 0.0},
    )
    assert vals[("x", "y")] == 0.04
    assert vals[("x", "z")] > 0.05
