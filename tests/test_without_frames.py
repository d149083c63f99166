"""The structure-learning path runs from numpy columns with pandas and
pyarrow unimportable (they are an optional extra)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys


class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "pyarrow"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Blocked())

import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

import pybnesian_tpu as pbn

rng = np.random.default_rng(0)
n = 240
a = rng.normal(size=n)
b = np.sin(a) + 0.5 * rng.normal(size=n)
c = 0.7 * b + 0.5 * rng.normal(size=n)
frame = {"a": a, "b": b, "c": c}
score = pbn.CVLikelihood(frame, k=3, seed=0)
model = pbn.hc(frame, bn_type=pbn.SemiparametricBNType(), score=score,
               max_iters=3, seed=0)
assert model.num_arcs() > 0, model.arcs()
model.fit(frame)
assert np.isfinite(model.slogl(frame))
gmodel = pbn.hc(frame, bn_type=pbn.GaussianNetworkType(), score="bic")
assert gmodel.num_arcs() > 0
assert "pandas" not in sys.modules and "pyarrow" not in sys.modules
print("OK", sorted(model.arcs()))
"""


def test_hc_and_cv_likelihood_without_pandas_or_pyarrow():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK"), proc.stdout
