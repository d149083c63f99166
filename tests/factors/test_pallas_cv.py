"""The streaming CV-CKDE path vs the XLA fused kernel, and the choice
between them.

The flash path (ops/kde.py ckde_cv_alldevice_flash) splits the fused kernel
into an XLA whitening stage and a Pallas double-logsumexp on the Triton
route; both must agree with ckde_cv_alldevice (same fold/bandwidth math).
Here the kernel runs in interpret mode; the ``gpu`` test compiles it.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pybnesian_tpu.ops.kde import ckde_cv_alldevice, ckde_cv_alldevice_flash


def _setup(F=4, n=512, D=4, K=3, djmax=2, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(0, 1.5, (n, D)).astype(np.float32)
    for j in range(1, D):
        data[:, j] += 0.7 * data[:, j - 1]
    null = np.zeros((n, D), np.float32)
    null[rng.random((n, D)) < 0.05] = 1.0
    data = np.where(null > 0, 0.0, data)

    col_idx = np.zeros((F, djmax), np.int32)
    col_mask = np.zeros((F, djmax), np.float32)
    # families: evidence first, variable last
    col_idx[0, 0] = 0
    col_mask[0, 0] = 1.0  # univariate
    for f in range(1, F):
        col_idx[f, 0] = (f + 1) % D
        col_idx[f, 1] = f % D
        col_mask[f, :2] = 1.0

    idx = rng.permutation(n)
    folds = np.array_split(idx, K)
    ntr = 256 * ((n - min(len(f) for f in folds)) // 256 + 1)
    nte = 256 * ((max(len(f) for f in folds) + 255) // 256)
    tr_idx = np.zeros((K, ntr), np.int32)
    tr_mask = np.zeros((K, ntr), np.float32)
    te_idx = np.zeros((K, nte), np.int32)
    te_mask = np.zeros((K, nte), np.float32)
    for k in range(K):
        te = folds[k]
        tr = np.concatenate([folds[j] for j in range(K) if j != k])
        tr_idx[k, : len(tr)] = tr
        tr_mask[k, : len(tr)] = 1.0
        te_idx[k, : len(te)] = te
        te_mask[k, : len(te)] = 1.0
    return (jnp.asarray(data), jnp.asarray(null), jnp.asarray(col_idx),
            jnp.asarray(col_mask), jnp.asarray(tr_idx), jnp.asarray(tr_mask),
            jnp.asarray(te_idx), jnp.asarray(te_mask))


@pytest.mark.parametrize("rule", ["nr", "scott"])
def test_flash_matches_xla_fused(rule):
    args = _setup()
    ref = np.asarray(ckde_cv_alldevice(*args, chunk=256, rule=rule))
    out = np.asarray(
        ckde_cv_alldevice_flash(*args, rule=rule, block_m=128, block_n=256,
                                interpret=True)
    )
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-3)


def test_flash_wider_family(seed=1):
    args = _setup(F=2, D=4, djmax=4, seed=1)
    ref = np.asarray(ckde_cv_alldevice(*args, chunk=256, rule="nr"))
    out = np.asarray(
        ckde_cv_alldevice_flash(*args, rule="nr", block_m=128, block_n=256,
                                interpret=True)
    )
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-3)


def test_flash_fallback_state_gates_by_backend():
    """The scoring path picks its kernel with cv_pairs_route from the
    platform and the dtype; on the CPU that is the XLA kernel, whose result
    _fused_cv_scores returns unchanged."""
    import jax

    import pybnesian_tpu.learning.scores.likelihood as lik
    from pybnesian_tpu.ops.kde import cv_pairs_route

    args = _setup()
    assert cv_pairs_route(jax.default_backend(), args[0].dtype) == "xla"
    out = np.asarray(lik._fused_cv_scores(*args, chunk=256, rule="nr"))
    ref = np.asarray(ckde_cv_alldevice(*args, chunk=256, rule="nr"))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize(
    "platform, dtype, route",
    [
        ("gpu", np.float32, "triton"),
        ("gpu", np.float64, "xla"),
        ("gpu", np.float16, "xla"),
        ("cpu", np.float32, "xla"),
        ("cpu", np.float64, "xla"),
    ],
)
def test_cv_pairs_route(platform, dtype, route):
    from pybnesian_tpu.ops.kde import cv_pairs_route

    assert cv_pairs_route(platform, dtype) == route


def test_fused_scores_follow_the_route(monkeypatch):
    """When the route says "triton", _fused_cv_scores runs the streaming
    kernel (here in interpret mode) and returns its result."""
    import pybnesian_tpu.ops.kde as kde_ops
    import pybnesian_tpu.learning.scores.likelihood as lik

    calls = []

    def flash(*a, **kw):
        calls.append(kw)
        return ckde_cv_alldevice_flash(*a, rule=kw["rule"], interpret=True)

    monkeypatch.setattr(kde_ops, "cv_pairs_route", lambda p, d: "triton")
    monkeypatch.setattr(kde_ops, "ckde_cv_alldevice_flash", flash)
    args = _setup(F=2, n=300)
    out = np.asarray(lik._fused_cv_scores(*args, chunk=256, rule="nr"))
    ref = np.asarray(ckde_cv_alldevice(*args, chunk=256, rule="nr"))
    assert len(calls) == 1
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=5e-3)


@pytest.mark.parametrize("block_m, block_n", [(32, 64), (64, 128)])
def test_flash_pads_rows_and_columns(block_m, block_n):
    """Train rows, test rows and the column count that are not multiples of
    the blocks (or a power of two) are padded by the wrapper; padded rows
    carry no weight."""
    rng = np.random.default_rng(3)
    n, D, K = 300, 3, 2
    data = jnp.asarray(rng.normal(size=(n, D)).astype(np.float32))
    null = jnp.zeros((n, D), jnp.float32)
    col_idx = jnp.asarray([[1, 2, 0], [0, 0, 0]], jnp.int32)
    col_mask = jnp.asarray([[1, 1, 1], [1, 0, 0]], jnp.float32)
    ntr, nte = 200, 100
    tr_idx = jnp.asarray(np.stack([np.arange(ntr), np.arange(n - ntr, n)])
                         .astype(np.int32))
    tr_mask = jnp.asarray(np.stack([np.ones(ntr), np.r_[np.ones(170),
                                                        np.zeros(30)]])
                          .astype(np.float32))
    te_idx = jnp.asarray(np.stack([np.arange(n - nte, n), np.arange(nte)])
                         .astype(np.int32))
    te_mask = jnp.ones((K, nte), jnp.float32)
    args = (data, null, col_idx, col_mask, tr_idx, tr_mask, te_idx, te_mask)
    ref = np.asarray(ckde_cv_alldevice(*args, chunk=100))
    out = np.asarray(ckde_cv_alldevice_flash(
        *args, block_m=block_m, block_n=block_n, interpret=True))
    np.testing.assert_allclose(out, ref, rtol=5e-5)


def test_flash_kernel_compiled_on_gpu(gpu):
    """The kernel as the GPU compiles it (not interpreted) against the XLA
    kernel."""
    args = _setup(F=4, n=2048, D=4, K=3, djmax=4)
    ref = np.asarray(ckde_cv_alldevice(*args, chunk=256))
    out = np.asarray(ckde_cv_alldevice_flash(*args))
    np.testing.assert_allclose(out, ref, rtol=1e-4)
