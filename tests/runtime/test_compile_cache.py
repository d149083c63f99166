"""One compile-cache rule, in runtime.config.enable_compile_cache."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROBE = (
    "import jax; from pybnesian_tpu.runtime.config import "
    "enable_compile_cache; p = enable_compile_cache(); "
    "print(p); print(jax.config.jax_compilation_cache_dir)"
)


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    proc = subprocess.run([sys.executable, "-c", PROBE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.split()


def test_env_variable_is_honoured(tmp_path):
    helper, jax_dir = _probe(str(tmp_path))
    assert helper == jax_dir == str(tmp_path)


def test_default_is_the_checkout_cache():
    helper, jax_dir = _probe(None)
    assert helper == jax_dir == os.path.join(REPO, ".jax_cache")


def test_no_other_code_sets_a_cache_location():
    """``jax_compilation_cache_dir`` is set in the one helper only."""
    paths = [os.path.join(REPO, f) for f in os.listdir(REPO)
             if f.endswith(".py")]
    for sub in ("pybnesian_tpu", "benchmarks", "tests", "tools"):
        for root, _, files in os.walk(os.path.join(REPO, sub)):
            paths += [os.path.join(root, f) for f in files
                      if f.endswith(".py")]
    hits = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            if "jax_compilation_cache_dir" in fh.read():
                hits.append(os.path.relpath(path, REPO))
    allowed = {os.path.join("pybnesian_tpu", "runtime", "config.py"),
               os.path.join("tests", "runtime", "test_compile_cache.py")}
    assert set(hits) <= allowed, hits
