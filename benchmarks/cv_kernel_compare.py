"""Streaming Pallas kernel vs XLA for CV-CKDE scoring, on a GPU.

    python benchmarks/cv_kernel_compare.py [--reps 10] [--trace-dir DIR]

Times the kernel call alone for the XLA kernel and a sweep of the Pallas
kernel's settings, then ``CVLikelihood.local_score_batch`` end to end on
the north-star shapes (10k rows × 5 variables, 10 folds, 15 families padded
to 16, train rows padded to 9216, test rows to 1024, up to 4 columns) with
each kernel, the Pallas one at its fastest setting, in the order triton,
xla, xla, triton. Then traces a steady window of each
route with ``jax.profiler`` and prints the top device operations, the
device busy time and the idle share of the window. One JSON line per
measurement; the first line is the card's name and power limit. Exits
non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time
from functools import partial
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    bench_families,
    bench_frame,
    card_line,
    config3_kernel_args,
)


#: (block_m, block_n, num_warps) settings of the kernel sweep; num_warps
#: is set through pybnesian_tpu.ops.pallas_kde.NUM_WARPS
SWEEP = [(32, 128, 4), (32, 64, 4), (64, 64, 4), (64, 128, 8), (16, 128, 4),
         (32, 32, 2)]


@contextlib.contextmanager
def _num_warps(n):
    """Compile the streaming kernel with ``n`` warps per program."""
    import jax

    from pybnesian_tpu.ops import pallas_kde

    saved = pallas_kde.NUM_WARPS
    pallas_kde.NUM_WARPS = n
    jax.clear_caches()
    try:
        yield
    finally:
        pallas_kde.NUM_WARPS = saved
        jax.clear_caches()


@contextlib.contextmanager
def _route(name, flash):
    """Force the CV-CKDE kernel choice (normally cv_pairs_route's) and the
    streaming kernel's settings."""
    with mock.patch("pybnesian_tpu.ops.kde.cv_pairs_route",
                    lambda platform, dtype: name), \
            mock.patch("pybnesian_tpu.ops.kde.ckde_cv_alldevice_flash",
                       flash):
        yield


def _batches(d):
    from pybnesian_tpu import CKDEType

    # same shapes, other gather indices: hill-climbing re-scores changing
    # family sets against one score instance
    return [[(v, ps, CKDEType()) for v, ps in bench_families(d, shift)]
            for shift in (1, 2, 3)]


def time_end_to_end(score, model, batches, reps):
    score.local_score_batch(model, batches[0])  # compile
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        score.local_score_batch(model, batches[r % len(batches)])
        times.append(time.perf_counter() - t0)
    return times


def device_summary(trace_dir, top=12):
    """Top device operations, busy time and idle share of a traced window,
    from the newest ``.xplane.pb`` under ``trace_dir``."""
    import glob

    import jax

    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    per_op: dict[str, float] = {}
    spans = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:  # one line per CUDA stream
            for ev in line.events:
                per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
    if not spans:
        return {"trace": path, "error": "no device op events in the trace"}
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        "trace": path,
        "device_busy_ms": busy / 1e6,
        "window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window,
        "top_ops_ms": [[name, ns / 1e6] for name, ns in ops],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--trace-dir", default="chiprun_out/cv_kernel_traces")
    args = ap.parse_args(argv)

    print(card_line(), flush=True)
    import jax

    from pybnesian_tpu import CVLikelihood, KDENetwork
    from pybnesian_tpu.ops.kde import ckde_cv_alldevice, ckde_cv_alldevice_flash
    from pybnesian_tpu.ops.pallas_kde import NUM_WARPS
    from pybnesian_tpu.runtime.config import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX runs on {dev.platform}", file=sys.stderr)
        return 2
    enable_compile_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    d = 5
    frame = bench_frame(10_000, d, 0)
    batches = _batches(d)
    n_fams = len(batches[0])
    model = KDENetwork(list(frame))
    scores = {r: CVLikelihood(frame, k=10, seed=0) for r in ("triton", "xla")}

    # the kernel call alone, on the scoring path's own device arrays
    kargs = config3_kernel_args(scores["xla"], bench_families(d))

    def kernel_time(fn, reps=args.reps):
        fn().block_until_ready()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn().block_until_ready()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    ref = np.asarray(ckde_cv_alldevice(*kargs, chunk=256), np.float64)
    t_xla = kernel_time(lambda: ckde_cv_alldevice(*kargs, chunk=256))
    print(json.dumps({"measure": "kernel_call", "route": "xla",
                      "median_s": t_xla, "device": device}), flush=True)
    best = (math.inf, {}, NUM_WARPS)
    for bm, bn, warps in SWEEP:
        cfg = {"block_m": bm, "block_n": bn}
        line = {"measure": "kernel_call", "route": "triton", **cfg,
                "num_warps": warps}
        try:
            with _num_warps(warps):
                fn = lambda: ckde_cv_alldevice_flash(*kargs, **cfg)  # noqa: E731
                got = np.asarray(fn(), np.float64)
                rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
                t = kernel_time(fn)
            if rel < 1e-4 and t < best[0]:
                best = (t, cfg, warps)
            line.update(median_s=t, max_rel_vs_xla=rel)
        except Exception as exc:  # a setting the compiler refuses
            line["error"] = f"{type(exc).__name__}: {str(exc)[:300]}"
        print(json.dumps({**line, "device": device}), flush=True)
    _, cfg, warps = best
    if warps != NUM_WARPS:
        print(json.dumps({"note": f"fastest num_warps {warps}; the end-to-end "
                          f"runs keep NUM_WARPS = {NUM_WARPS}"}), flush=True)
    flash = partial(ckde_cv_alldevice_flash, **cfg)

    # end to end, interleaved: triton, xla, xla, triton
    e2e = {"triton": [], "xla": []}
    for route in ("triton", "xla", "xla", "triton"):
        with _route(route, flash):
            e2e[route] += time_end_to_end(scores[route], model, batches,
                                          args.reps)
    for route, ts in e2e.items():
        med = statistics.median(ts)
        print(json.dumps({
            "measure": "local_score_batch", "route": route,
            **({**cfg, "num_warps": NUM_WARPS} if route == "triton" else {}),
            "median_s": med, "min_s": min(ts), "max_s": max(ts),
            "family_scores_per_s": n_fams / med, "n": len(ts),
            "device": device}), flush=True)

    # a steady traced window of each route
    for route in ("triton", "xla"):
        tdir = os.path.join(args.trace_dir, route)
        with _route(route, flash):
            scores[route].local_score_batch(model, batches[0])
            with jax.profiler.trace(tdir):
                for b in batches:
                    scores[route].local_score_batch(model, b)
        print(json.dumps({"measure": "trace", "route": route,
                          **device_summary(tdir), "device": device}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
