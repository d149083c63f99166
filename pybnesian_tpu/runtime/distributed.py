"""Multi-host bootstrap: ``jax.distributed.initialize`` wiring so the same
SPMD code (parallel/*, inference/hmc.py) runs on several hosts untouched.

The reference has no distributed story at all (SURVEY.md §2.13); this module
is net-new. Contract mirrors the standard JAX multi-process model:

- one Python process per host, each seeing its local devices;
- ``initialize()`` wires the cluster from explicit arguments or the
  ``PBN_COORDINATOR`` / ``PBN_NUM_PROCESSES`` / ``PBN_PROCESS_ID`` env vars
  (falling back to JAX's own cluster auto-detection, e.g. SLURM);
- ``global_mesh()`` then builds a Mesh over ALL global devices — pass it to
  ``parallel.sharded_*`` / ``inference.sample_chains_sharded`` and XLA routes
  collectives over the host's device links and the network across hosts.

Single-process use is a no-op: ``initialize()`` returns False and
``global_mesh()`` degrades to the local-device mesh.
"""

from __future__ import annotations

import os

__all__ = [
    "initialize",
    "shutdown",
    "is_distributed",
    "global_mesh",
    "process_summary",
]

_INITIALIZED = False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> bool:
    """Bootstrap the multi-process JAX runtime.

    Resolution order per argument: explicit argument > ``PBN_*`` env var >
    JAX cluster auto-detection (e.g. SLURM). Returns True when a
    multi-process runtime was initialized, False for the single-process
    no-op (num_processes == 1 with no coordinator)."""
    global _INITIALIZED
    if _INITIALIZED:
        return True

    coordinator_address = coordinator_address or os.environ.get(
        "PBN_COORDINATOR"
    )
    if num_processes is None and "PBN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PBN_NUM_PROCESSES"])
    if process_id is None and "PBN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PBN_PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        # single process — nothing to wire
        return False

    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _INITIALIZED = True
    return True


def shutdown() -> None:
    global _INITIALIZED
    if _INITIALIZED:
        import jax

        jax.distributed.shutdown()
        _INITIALIZED = False


def is_distributed() -> bool:
    import jax

    return jax.process_count() > 1


def global_mesh(fam: int = 1):
    """(data, fam) mesh over ALL global devices (every process must call this
    with the same arguments). Data-parallel axis spans hosts — lay the
    heavier 'data' collectives along it so psum rides the device links within
    a host before crossing the network; the 'fam' axis (embarrassingly parallel candidate
    families) carries no collectives at all."""
    from ..parallel import make_mesh
    import jax

    n = len(jax.devices())
    if n % fam != 0:
        raise ValueError("fam axis must divide the global device count")
    return make_mesh({"data": n // fam, "fam": fam})


def process_summary() -> dict:
    import jax

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": [str(d) for d in jax.local_devices()],
        "global_devices": len(jax.devices()),
        "initialized_multiprocess": _INITIALIZED,
    }
