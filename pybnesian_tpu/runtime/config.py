"""Runtime configuration: device discovery, dtype policy, mesh defaults,
profiling hooks.

This module replaces the reference's ``OpenCLConfig`` singleton
(opencl/opencl_config.hpp:120-292) — which hard-coded platform 0 / device 0
and owned the kernel cache — with the JAX-native equivalents: device/mesh
discovery, a process-wide dtype policy (the reference's float/double template
split), and `jax.profiler` trace hooks (net-new; the reference has no
tracing, SURVEY.md §5.1).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np

__all__ = [
    "RuntimeConfig",
    "compile_cache_dir",
    "device_info",
    "default_mesh",
    "dtype_policy",
    "enable_compile_cache",
    "set_dtype_policy",
    "trace",
]

#: the checkout (or install prefix) that holds the package directory
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


@dataclasses.dataclass
class RuntimeConfig:
    compute_dtype: np.dtype = np.dtype(np.float32)
    #: axis sizes for the default mesh; None = 1-D data mesh over all devices
    mesh_axes: dict | None = None


_CONFIG = RuntimeConfig()


def dtype_policy() -> np.dtype:
    """Default device compute dtype. float32 on accelerators; tests enable
    x64 and the kernels follow the data dtype, so this is the fallback
    only."""
    return _CONFIG.compute_dtype


def set_dtype_policy(dtype) -> None:
    _CONFIG.compute_dtype = np.dtype(dtype)


def device_info() -> dict:
    """Platform/device summary (replaces OpenCLConfig's device selection)."""
    import jax

    devices = jax.devices()
    return {
        "backend": jax.default_backend(),
        "num_devices": len(devices),
        "devices": [str(d) for d in devices],
        "process_index": jax.process_index(),
        "num_processes": jax.process_count(),
    }


def default_mesh():
    """1-D data mesh over every visible device."""
    from ..parallel import make_mesh

    import jax

    return make_mesh({"data": len(jax.devices())})


@contextlib.contextmanager
def trace(name: str, log_dir: str | None = None):
    """jax.profiler trace context; annotates the region when no log_dir is
    given, writes a full profile otherwise."""
    import jax

    if log_dir is not None:
        with jax.profiler.trace(log_dir):
            with jax.profiler.TraceAnnotation(name):
                yield
    else:
        with jax.profiler.TraceAnnotation(name):
            yield


def compile_cache_dir() -> str:
    """Where JAX's persistent compilation cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``.
    The path is part of the cache key, so it is fixed, never derived from a
    temporary name, a PID or the time."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache, the one place that names
    its directory. When ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it
    itself and nothing is set here; otherwise the cache goes to
    ``<checkout>/.jax_cache``. Returns the directory in use."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
