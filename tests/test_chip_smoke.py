"""CPU rehearsal of chip_smoke.py: every phase at a tiny size, and main()
refusing to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run(name, build):
    failures = []
    line = cs.run_phase(name, build, failures)
    assert not failures, line
    assert line["ok"] and line["seconds"]["steady"] >= 0
    return line


def test_phase_ckde_cv_small():
    line = _run("ckde_cv", lambda: cs.phase_ckde_cv(n=600))
    assert line["route"] == "xla" and line["max_rel_diff"] < 1e-4


def test_phases_hc_spbn_and_slogl_small():
    learned = {}
    _run("hc_spbn", lambda: cs.phase_hc_spbn(n=500, max_iters=2,
                                             keep=learned))
    line = _run("slogl", lambda: cs.phase_slogl(learned["model"],
                                                learned["frame"]))
    assert len(line["ckde_nodes"]) >= 2


def test_phase_hc_bic_small_takes_the_device_path():
    line = _run("hc_bic", lambda: cs.phase_hc_bic(n=3000, d=10,
                                                  max_iters=4))
    assert line["device_bic_calls"] > 0


def test_phase_rcot_small():
    _run("rcot", lambda: cs.phase_rcot(n=800, n_tests=8, n_parity=1))


def test_phase_pc_small():
    _run("pc", lambda: cs.phase_pc(n=4000, d=6))


def test_phase_nuts_small():
    _run("nuts", lambda: cs.phase_nuts(n=1500, num_samples=40,
                                       num_warmup=40))


def test_mesh_phase_small():
    """The four-card cases on the test mesh (2 × 2 of the virtual CPU
    devices), each against its one-device form."""
    from pybnesian_tpu.parallel import data_fam_mesh

    cases = cs.phase_mesh(data_fam_mesh(4, fam=2), n_ckde=600, n_rows=2000,
                          n_train=256, num_samples=20)
    assert {"sharded_ckde_cv", "sharded_lg_fit", "sharded_batched_bic",
            "sharded_kde_slogl_all_gather", "sharded_kde_slogl_pmax_psum",
            "sample_chains_sharded"} <= set(cases)
    for name, (sharded, single, compare) in cases.items():
        if name == "sample_chains_sharded":
            continue  # NUTS under jit on CPU is slow; covered on the card
        got = sharded()
        assert np.all(np.isfinite(got)), name
        compare(got, single())


def test_main_refuses_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(cs, "card_line", lambda: "fake card, 700.00 W")
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out


def test_script_fails_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          env=env, capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("n, d", [(50, 3), (200, 6)])
def test_frames_are_seeded_float32_columns(n, d):
    a = cs.bench_frame(n, d, seed=3)
    b = cs.bench_frame(n, d, seed=3)
    assert list(a) == [f"x{i}" for i in range(d)]
    for k in a:
        assert a[k].dtype == np.float32 and a[k].shape == (n,)
        np.testing.assert_array_equal(a[k], b[k])
    assert len(cs.bench_families(d)) == 3 * d
