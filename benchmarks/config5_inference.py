"""BASELINE config 5: NUTS posterior sampling over CLG parameters of a
dynamic-BN-style model, chains sharded over the device mesh.

Metric: NUTS samples/s (all chains) on the available devices, with the
single-chain rate as baseline — measuring the mesh scaling the reference
cannot express at all (SURVEY.md §2.13).

Prints ONE JSON line.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pybnesian_tpu.runtime.config import enable_compile_cache  # noqa: E402

enable_compile_cache()


def make_data(n=2000, seed=0):
    import pandas as pd

    rng = np.random.default_rng(seed)
    a = pd.Categorical.from_codes(rng.integers(0, 2, n), ["lo", "hi"])
    x = np.where(a.codes == 1, 1.0, -1.0) + rng.normal(0, 0.5, n)
    y = 0.8 * x + rng.normal(0, 0.4, n)
    return pd.DataFrame({"A": a, "X": x, "Y": y})


NUM_SAMPLES = 300
NUM_WARMUP = 200


def main():
    from pybnesian_tpu import CLGNetwork
    from pybnesian_tpu.inference import make_logdensity, nuts, sample_chains_sharded
    from pybnesian_tpu.parallel import make_mesh

    df = make_data()
    model = CLGNetwork(["A", "X", "Y"], [("A", "X"), ("X", "Y")])
    logp, layout, init = make_logdensity(model, df, dtype=np.float64)

    # single chain (baseline unit); first call compiles, second measures
    def single_run(k):
        samples, _ = nuts(logp, init, jax.random.PRNGKey(k),
                          num_samples=NUM_SAMPLES, num_warmup=NUM_WARMUP,
                          max_depth=6)
        np.asarray(samples)  # block

    single_run(0)
    t0 = time.time()
    single_run(1)
    single = NUM_SAMPLES / (time.time() - t0)

    # chains sharded over all devices
    n_dev = len(jax.devices())
    per_dev = max(1, 4 // n_dev)
    n_chains = n_dev * per_dev
    mesh = make_mesh({"data": n_dev})

    def sharded_run(k):
        chains, _info = sample_chains_sharded(
            logp, init, jax.random.PRNGKey(k), mesh,
            chains_per_device=per_dev, method="nuts",
            num_samples=NUM_SAMPLES, num_warmup=NUM_WARMUP, max_depth=6,
        )
        np.asarray(chains)  # block
        return _info

    sharded_run(1)
    t0 = time.time()
    info = sharded_run(2)
    rate = n_chains * NUM_SAMPLES / (time.time() - t0)

    # hardware self-audit: useful gradient evaluations per second (mean
    # leapfrogs per kept sample, reported by the chain-batched sampler)
    # vs the chip's raw batched-gradient rate measured standalone. The gap
    # is tree bookkeeping + lanes wasted on already-U-turned chains.
    try:
        import jax.numpy as jnp

        mean_lf = float(np.mean(np.asarray(info["mean_leapfrogs"])))
        vg = jax.vmap(jax.value_and_grad(logp))
        th = jnp.zeros((n_chains, init.shape[0]), init.dtype)

        CH = 20_000  # long dependent chain: amortizes the dispatch cost

        @jax.jit
        def grad_chain(t):
            def body(c, _):
                _lp, g = vg(c)
                return c + 1e-9 * g, None

            out, _ = jax.lax.scan(body, t, None, length=CH)
            return out

        np.asarray(grad_chain(th))
        t0 = time.time()
        np.asarray(grad_chain(th + 1e-6))
        grad_ceiling = CH * n_chains / (time.time() - t0)
        achieved = rate * mean_lf
        roofline_fraction = round(achieved / grad_ceiling, 2)
    except Exception:
        mean_lf = None
        roofline_fraction = None

    print(json.dumps({
        "metric": "config5_nuts_samples_per_s",
        "value": round(rate, 1),
        "unit": f"NUTS samples/s ({n_chains} chains on {n_dev} device(s))",
        "vs_baseline": round(rate / single, 2),
        "mean_leapfrogs_per_sample": round(mean_lf, 1) if mean_lf else None,
        "roofline_fraction": roofline_fraction,
        "roofline_basis": "useful grad-evals/s vs standalone batched-gradient rate",
    }))


if __name__ == "__main__":
    main()
