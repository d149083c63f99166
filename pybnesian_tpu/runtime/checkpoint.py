"""Orbax-backed checkpoint/resume.

The reference's only checkpointing is pickling the model each hill-climbing
iteration (learning/algorithms/callbacks/save_model.hpp:8-30) with no resume
logic — SURVEY.md §5.4. This module adds device-state checkpoints:

- ``save_pytree`` / ``load_pytree``: device-state checkpoints (orbax) for any
  JAX pytree — posterior-inference states, sharded arrays.
- ``nuts_checkpointed``: long NUTS runs that persist (position, rng, adapted
  step/mass, collected blocks) after every block and resume mid-run after
  the job is preempted or killed, which the reference cannot express.
- Structure-search resume needs no new machinery: ``SaveModel`` writes the
  model per iteration and ``hc(start=load(...))`` continues from it
  (validated in tests/learning/test_checkpoint.py).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["save_pytree", "load_pytree", "nuts_checkpointed"]


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def save_pytree(path: str, tree) -> None:
    """Persist a JAX pytree (device arrays included) with orbax."""
    path = os.path.abspath(path)
    ckpt = _checkpointer()
    ckpt.save(path, tree, force=True)
    ckpt.wait_until_finished()


def load_pytree(path: str, template=None):
    """Restore a pytree saved by :func:`save_pytree`. ``template`` (matching
    structure of abstract/real arrays) restores exact dtypes/shardings."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckpt = _checkpointer()
    if template is not None:
        template = jax.tree.map(ocp.utils.to_shape_dtype_struct, template)
        return ckpt.restore(path, template)
    return ckpt.restore(path)


def nuts_checkpointed(logdensity, init, key, checkpoint_dir: str,
                      num_samples: int = 1000, block_size: int = 100,
                      num_warmup: int = 500, max_depth: int = 6,
                      initial_step: float = 0.1, target_accept: float = 0.8):
    """NUTS with per-block checkpointing and automatic resume.

    Runs warmup once, then samples in blocks of ``block_size``; after each
    block the full sampler state (position, rng key, adapted step size and
    mass, samples so far) is written to ``checkpoint_dir``. If the directory
    already holds a state (e.g. the process was preempted), sampling resumes
    from the last completed block — warmup is not repeated.

    Returns (samples, info) like :func:`pybnesian_tpu.inference.nuts`.
    """
    from ..inference.hmc import _nuts_step, nuts

    checkpoint_dir = os.path.abspath(checkpoint_dir)
    state_path = os.path.join(checkpoint_dir, "state")
    num_blocks = -(-num_samples // block_size)

    state = None
    if os.path.isdir(state_path):
        state = load_pytree(state_path)

    if state is None:
        # fresh start: adapt with a short nuts run of 0 samples is wasteful;
        # reuse nuts() for warmup by sampling one block with it
        warm_samples, info = nuts(
            logdensity, init, key, num_samples=block_size,
            num_warmup=num_warmup, max_depth=max_depth,
            initial_step=initial_step, target_accept=target_accept,
        )
        theta = warm_samples[-1]
        key = jax.random.fold_in(key, 1)
        state = {
            "theta": theta,
            "key": key,
            "step": info["step_size"],
            "inv_mass": info["inv_mass"],
            "blocks_done": jnp.asarray(1),
            "samples": jnp.asarray(warm_samples),
        }
        save_pytree(state_path, state)

    vg = jax.value_and_grad(logdensity)

    def block(theta, key, step, inv_mass):
        logp, grad = vg(theta)

        def sample_step(carry, _):
            theta, logp, grad, key = carry
            theta, logp, grad, key, accept = _nuts_step(
                vg, theta, logp, grad, key, step, inv_mass, max_depth
            )
            return (theta, logp, grad, key), (theta, accept)

        (theta, _, _, key), (samples, accepts) = jax.lax.scan(
            sample_step, (theta, logp, grad, key), None, length=block_size
        )
        return theta, key, samples, jnp.mean(accepts)

    block_jit = jax.jit(block)

    blocks_done = int(state["blocks_done"])
    while blocks_done < num_blocks:
        theta, key, samples, _acc = block_jit(
            state["theta"], state["key"], state["step"], state["inv_mass"]
        )
        state = {
            "theta": theta,
            "key": key,
            "step": state["step"],
            "inv_mass": state["inv_mass"],
            "blocks_done": jnp.asarray(blocks_done + 1),
            "samples": jnp.concatenate([state["samples"], samples], axis=0),
        }
        save_pytree(state_path, state)
        blocks_done += 1

    samples = state["samples"][:num_samples]
    info = {"step_size": state["step"], "inv_mass": state["inv_mass"]}
    return samples, info
