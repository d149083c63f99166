"""Hamiltonian Monte Carlo + NUTS over network parameters.

Net-new subsystem. The leapfrog integrator, the NUTS tree
doubling and the warmup adaptation (dual-averaging step size + diagonal mass
matrix) are pure jittable functions; chains vectorize with vmap and shard
over a device mesh axis (see :func:`sample_chains_sharded`) so chains/s scale
with devices.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["hmc", "nuts", "nuts_chains", "sample_chains",
           "sample_chains_sharded"]


class DualAveragingState(NamedTuple):
    log_step: jnp.ndarray
    log_step_avg: jnp.ndarray
    h_avg: jnp.ndarray
    mu: jnp.ndarray
    count: jnp.ndarray


def _da_init(step_size):
    log_step = jnp.log(step_size)
    return DualAveragingState(
        log_step, jnp.zeros_like(log_step), jnp.zeros_like(log_step),
        jnp.log(10.0) + log_step, jnp.zeros_like(log_step),
    )


def _da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0,
               kappa=0.75):
    count = state.count + 1.0
    h_avg = (1.0 - 1.0 / (count + t0)) * state.h_avg + (
        target - accept_prob
    ) / (count + t0)
    log_step = state.mu - jnp.sqrt(count) / gamma * h_avg
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_avg, state.mu, count)


def _leapfrog(logdensity_grad, theta, momentum, step, inv_mass, n_steps,
              logp_grad=None):
    """Velocity-Verlet with the end-point gradient threaded through the
    carry: the trailing half-kick gradient of step k IS the leading
    half-kick gradient of step k+1, so a trajectory costs exactly
    ``n_steps`` gradient evaluations (not 2·n_steps). Returns
    ``(theta, momentum, (logp, grad))`` with the density/gradient at the
    final point, so callers never re-evaluate it."""
    if logp_grad is None:
        logp_grad = logdensity_grad(theta)

    def body(_, carry):
        th, m, (lp, g) = carry
        m = m + 0.5 * step * g
        th = th + step * m * inv_mass
        lp, g = logdensity_grad(th)
        m = m + 0.5 * step * g
        return th, m, (lp, g)

    return jax.lax.fori_loop(0, n_steps, body, (theta, momentum, logp_grad))


def _kinetic(momentum, inv_mass):
    return 0.5 * jnp.sum(jnp.square(momentum) * inv_mass)


def hmc(logdensity: Callable, init, key, num_samples: int = 1000,
        num_warmup: int = 500, num_leapfrog: int = 16,
        initial_step: float = 0.1, target_accept: float = 0.8,
        jitter_steps: bool = True):
    """Adaptive HMC: dual-averaging step size and diagonal mass matrix fitted
    during warmup, trajectory length jittered to decorrelate (the standard
    robust alternative to dynamic termination). Returns (samples, info)."""
    vg = jax.value_and_grad(logdensity)
    dim = init.shape[0]

    def one_step(theta, logp, grad, key, step, inv_mass, n_steps):
        key, km, ku, kj = jax.random.split(key, 4)
        momentum = jax.random.normal(km, (dim,), theta.dtype) / jnp.sqrt(
            inv_mass
        )
        steps = jax.lax.select(
            jnp.asarray(jitter_steps),
            1 + jax.random.randint(kj, (), 0, n_steps),
            jnp.asarray(n_steps),
        )
        new_theta, new_momentum, (new_logp, new_grad) = _leapfrog(
            vg, theta, momentum, step, inv_mass, steps, (logp, grad)
        )
        delta_h = (
            new_logp - logp - _kinetic(new_momentum, inv_mass)
            + _kinetic(momentum, inv_mass)
        )
        accept_prob = jnp.minimum(1.0, jnp.exp(delta_h))
        accept_prob = jnp.where(jnp.isnan(accept_prob), 0.0, accept_prob)
        accept = jax.random.uniform(ku, (), theta.dtype) < accept_prob
        theta = jnp.where(accept, new_theta, theta)
        logp = jnp.where(accept, new_logp, logp)
        grad = jnp.where(accept, new_grad, grad)
        return theta, logp, grad, key, accept_prob

    logp0, grad0 = vg(init)

    def warmup_step(carry, _):
        theta, logp, grad, key, da, mean, m2, count = carry
        step = jnp.exp(da.log_step)
        inv_mass = jnp.where(
            count > 10.0, m2 / jnp.maximum(count - 1.0, 1.0), jnp.ones(dim)
        )
        inv_mass = jnp.maximum(inv_mass, 1e-6)
        theta, logp, grad, key, accept_prob = one_step(
            theta, logp, grad, key, step, inv_mass, num_leapfrog
        )
        da = _da_update(da, accept_prob, target=target_accept)
        count = count + 1.0
        delta = theta - mean
        mean = mean + delta / count
        m2 = m2 + delta * (theta - mean)
        return (theta, logp, grad, key, da, mean, m2, count), accept_prob

    da0 = _da_init(jnp.asarray(initial_step, init.dtype))
    carry = (
        init, logp0, grad0, key, da0, jnp.zeros(dim, init.dtype),
        jnp.zeros(dim, init.dtype), jnp.asarray(0.0, init.dtype),
    )
    carry, warm_accept = jax.lax.scan(
        warmup_step, carry, None, length=num_warmup
    )
    theta, logp, grad, key, da, mean, m2, count = carry
    step = jnp.exp(da.log_step_avg)
    inv_mass = jnp.maximum(m2 / jnp.maximum(count - 1.0, 1.0), 1e-6)

    def sample_step(carry, _):
        theta, logp, grad, key = carry
        theta, logp, grad, key, accept_prob = one_step(
            theta, logp, grad, key, step, inv_mass, num_leapfrog
        )
        return (theta, logp, grad, key), (theta, accept_prob)

    _, (samples, accepts) = jax.lax.scan(
        sample_step, (theta, logp, grad, key), None, length=num_samples
    )
    info = {
        "step_size": step,
        "accept_rate": jnp.mean(accepts),
        "warmup_accept_rate": jnp.mean(warm_accept),
        "inv_mass": inv_mass,
    }
    return samples, info


def _nuts_step(vg, theta, logp, grad, key, step, inv_mass, max_depth):
    """One multinomial-NUTS transition with static tree doubling.

    The doubling recursion is unrolled over ``max_depth`` (each level extends
    the trajectory away from the current tree), with a U-turn check per
    level — compiles to a static trace, XLA-friendly. Endpoint and sampled-
    point gradients ride in the tree state, so each leapfrog step costs
    exactly ONE density+gradient evaluation (the reference-free redesign of
    the usual recompute-at-segment-start pattern)."""
    dim = theta.shape[0]
    key, km, kd = jax.random.split(key, 3)
    momentum = jax.random.normal(km, (dim,), theta.dtype) / jnp.sqrt(inv_mass)
    h0 = logp - _kinetic(momentum, inv_mass)

    # trajectory state: endpoints (+ their density/gradient), sampled point
    # (multinomial, + its density/gradient), log weight
    state = {
        "theta_minus": theta, "r_minus": momentum,
        "lp_minus": logp, "g_minus": grad,
        "theta_plus": theta, "r_plus": momentum,
        "lp_plus": logp, "g_plus": grad,
        "sample": theta, "sample_lp": logp, "sample_g": grad,
        "logw_sum": jnp.asarray(0.0, theta.dtype),
        "turned": jnp.asarray(False),
        "sum_accept": jnp.asarray(0.0, theta.dtype),
        "n_steps": jnp.asarray(0.0, theta.dtype),
        "key": kd,
    }

    def extend(level, state):
        n_sub = 2**level

        def do_extend(state):
            key, kdir, ksel = jax.random.split(state["key"], 3)
            go_right = jax.random.bernoulli(kdir)
            th0 = jnp.where(go_right, state["theta_plus"], state["theta_minus"])
            r0 = jnp.where(go_right, state["r_plus"], -state["r_minus"])
            lp0 = jnp.where(go_right, state["lp_plus"], state["lp_minus"])
            g0 = jnp.where(go_right, state["g_plus"], state["g_minus"])

            def leap(carry, _):
                th, r, lp, g, logw, samp, samp_lp, samp_g, key2, sum_a = carry
                th, r, (lp, g) = _leapfrog(
                    vg, th, r, step, inv_mass, 1, (lp, g)
                )
                logw_new = lp - _kinetic(r, inv_mass) - h0
                logw_new = jnp.where(
                    jnp.isnan(logw_new), -jnp.inf, logw_new
                )
                sum_a = sum_a + jnp.minimum(1.0, jnp.exp(logw_new))
                # multinomial sampling within the new segment
                key2, ks = jax.random.split(key2)
                total = jnp.logaddexp(logw, logw_new)
                take = jax.random.uniform(ks, (), th.dtype) < jnp.exp(
                    logw_new - total
                )
                samp = jnp.where(take, th, samp)
                samp_lp = jnp.where(take, lp, samp_lp)
                samp_g = jnp.where(take, g, samp_g)
                return (th, r, lp, g, total, samp, samp_lp, samp_g, key2,
                        sum_a), None

            (th_end, r_end, lp_end, g_end, logw_seg, samp_seg, samp_lp_seg,
             samp_g_seg, _, sum_a), _ = (
                jax.lax.scan(
                    leap,
                    (th0, r0, lp0, g0,
                     -jnp.inf * jnp.ones((), theta.dtype),
                     th0, lp0, g0, ksel, jnp.asarray(0.0, theta.dtype)),
                    None,
                    length=n_sub,
                )
            )
            # candidate merged endpoints
            theta_minus = jnp.where(
                go_right, state["theta_minus"], th_end
            )
            r_minus = jnp.where(go_right, state["r_minus"], -r_end)
            lp_minus = jnp.where(go_right, state["lp_minus"], lp_end)
            g_minus = jnp.where(go_right, state["g_minus"], g_end)
            theta_plus = jnp.where(go_right, th_end, state["theta_plus"])
            r_plus = jnp.where(go_right, r_end, state["r_plus"])
            lp_plus = jnp.where(go_right, lp_end, state["lp_plus"])
            g_plus = jnp.where(go_right, g_end, state["g_plus"])

            dtheta = theta_plus - theta_minus
            turned = (
                jnp.sum(dtheta * r_minus * inv_mass) < 0
            ) | (jnp.sum(dtheta * r_plus * inv_mass) < 0)
            diverged = logw_seg < -1000.0

            # NUTS semantics: a subtree that triggers the U-turn/divergence
            # condition is DISCARDED, not merged — only the stopping flag and
            # accept statistics survive from it.
            key, kmerge = jax.random.split(key)
            total = jnp.logaddexp(state["logw_sum"], logw_seg)
            take_new = jax.random.uniform(kmerge, (), theta.dtype) < jnp.exp(
                logw_seg - total
            )
            keep = ~(turned | diverged)
            take = keep & take_new
            return {
                "theta_minus": jnp.where(keep, theta_minus, state["theta_minus"]),
                "r_minus": jnp.where(keep, r_minus, state["r_minus"]),
                "lp_minus": jnp.where(keep, lp_minus, state["lp_minus"]),
                "g_minus": jnp.where(keep, g_minus, state["g_minus"]),
                "theta_plus": jnp.where(keep, theta_plus, state["theta_plus"]),
                "r_plus": jnp.where(keep, r_plus, state["r_plus"]),
                "lp_plus": jnp.where(keep, lp_plus, state["lp_plus"]),
                "g_plus": jnp.where(keep, g_plus, state["g_plus"]),
                "sample": jnp.where(take, samp_seg, state["sample"]),
                "sample_lp": jnp.where(take, samp_lp_seg, state["sample_lp"]),
                "sample_g": jnp.where(take, samp_g_seg, state["sample_g"]),
                "logw_sum": jnp.where(keep, total, state["logw_sum"]),
                "turned": turned | diverged,
                "sum_accept": state["sum_accept"] + sum_a,
                "n_steps": state["n_steps"] + n_sub,
                "key": key,
            }

        return jax.lax.cond(state["turned"], lambda s: s, do_extend, state)

    for level in range(max_depth):
        state = extend(level, state)

    accept_stat = state["sum_accept"] / jnp.maximum(state["n_steps"], 1.0)
    return (state["sample"], state["sample_lp"], state["sample_g"], key,
            accept_stat)


def nuts(logdensity: Callable, init, key, num_samples: int = 1000,
         num_warmup: int = 500, max_depth: int = 6,
         initial_step: float = 0.1, target_accept: float = 0.8):
    """No-U-Turn sampler with multinomial trajectory sampling and static
    doubling (see _nuts_step). Warmup adapts step size (dual averaging) and a
    diagonal mass matrix. Returns (samples, info)."""
    vg = jax.value_and_grad(logdensity)
    dim = init.shape[0]
    logp0, grad0 = vg(init)

    def warmup_step(carry, _):
        theta, logp, grad, key, da, mean, m2, count = carry
        step = jnp.exp(da.log_step)
        inv_mass = jnp.where(
            count > 10.0,
            jnp.maximum(m2 / jnp.maximum(count - 1.0, 1.0), 1e-6),
            jnp.ones(dim, theta.dtype),
        )
        theta, logp, grad, key, accept = _nuts_step(
            vg, theta, logp, grad, key, step, inv_mass, max_depth
        )
        da = _da_update(da, accept, target=target_accept)
        count = count + 1.0
        delta = theta - mean
        mean = mean + delta / count
        m2 = m2 + delta * (theta - mean)
        return (theta, logp, grad, key, da, mean, m2, count), accept

    da0 = _da_init(jnp.asarray(initial_step, init.dtype))
    carry = (
        init, logp0, grad0, key, da0, jnp.zeros(dim, init.dtype),
        jnp.zeros(dim, init.dtype), jnp.asarray(0.0, init.dtype),
    )
    carry, warm_accept = jax.lax.scan(warmup_step, carry, None,
                                      length=num_warmup)
    theta, logp, grad, key, da, mean, m2, count = carry
    step = jnp.exp(da.log_step_avg)
    inv_mass = jnp.maximum(m2 / jnp.maximum(count - 1.0, 1.0), 1e-6)

    def sample_step(carry, _):
        theta, logp, grad, key = carry
        theta, logp, grad, key, accept = _nuts_step(
            vg, theta, logp, grad, key, step, inv_mass, max_depth
        )
        return (theta, logp, grad, key), (theta, accept)

    _, (samples, accepts) = jax.lax.scan(
        sample_step, (theta, logp, grad, key), None, length=num_samples
    )
    info = {
        "step_size": step,
        "accept_rate": jnp.mean(accepts),
        "warmup_accept_rate": jnp.mean(warm_accept),
        "inv_mass": inv_mass,
    }
    return samples, info


def _nuts_step_chains(vg_b, theta, logp, grad, key, step, inv_mass,
                      max_depth):
    """Chain-batched :func:`_nuts_step`: the chain axis C is explicit
    (theta (C, d), logp (C,), per-chain keys (C, 2), per-chain step and
    diagonal mass), and each doubling level hides behind a SCALAR
    ``any(still-extending)`` predicate. Under ``vmap(nuts)`` the per-level
    ``lax.cond(turned, ...)`` lowers to select, so every chain pays all
    2^max_depth − 1 leapfrogs per transition; here whole levels are
    skipped once EVERY chain has U-turned. Per-chain arithmetic and RNG
    streams mirror the vmapped form exactly (turned chains keep their old
    key, state, and statistics)."""
    C, dim = theta.shape

    def kin(m):
        return 0.5 * jnp.sum(jnp.square(m) * inv_mass, axis=1)

    k3 = jax.vmap(lambda k: jax.random.split(k, 3))(key)
    key_out, km, kd = k3[:, 0], k3[:, 1], k3[:, 2]
    momentum = jax.vmap(
        lambda k: jax.random.normal(k, (dim,), theta.dtype)
    )(km) / jnp.sqrt(inv_mass)
    h0 = logp - kin(momentum)

    state = {
        "theta_minus": theta, "r_minus": momentum,
        "lp_minus": logp, "g_minus": grad,
        "theta_plus": theta, "r_plus": momentum,
        "lp_plus": logp, "g_plus": grad,
        "sample": theta, "sample_lp": logp, "sample_g": grad,
        "logw_sum": jnp.zeros(C, theta.dtype),
        "turned": jnp.zeros(C, bool),
        "sum_accept": jnp.zeros(C, theta.dtype),
        "n_steps": jnp.zeros(C, theta.dtype),
        "key": kd,
    }

    def extend(level, state):
        n_sub = 2**level

        def do_extend(state):
            active = ~state["turned"]
            ks = jax.vmap(lambda k: jax.random.split(k, 3))(state["key"])
            key_new, kdir, ksel = ks[:, 0], ks[:, 1], ks[:, 2]
            go_right = jax.vmap(jax.random.bernoulli)(kdir)
            gr = go_right[:, None]
            th0 = jnp.where(gr, state["theta_plus"], state["theta_minus"])
            r0 = jnp.where(gr, state["r_plus"], -state["r_minus"])
            lp0 = jnp.where(go_right, state["lp_plus"], state["lp_minus"])
            g0 = jnp.where(gr, state["g_plus"], state["g_minus"])

            def leap(carry, _):
                th, r, lp, g, logw, samp, samp_lp, samp_g, key2, sum_a = carry
                r = r + 0.5 * step[:, None] * g
                th = th + step[:, None] * r * inv_mass
                lp, g = vg_b(th)
                r = r + 0.5 * step[:, None] * g
                logw_new = lp - kin(r) - h0
                logw_new = jnp.where(
                    jnp.isnan(logw_new), -jnp.inf, logw_new
                )
                sum_a = sum_a + jnp.minimum(1.0, jnp.exp(logw_new))
                ks2 = jax.vmap(lambda k: jax.random.split(k, 2))(key2)
                key2, kt = ks2[:, 0], ks2[:, 1]
                total = jnp.logaddexp(logw, logw_new)
                take = jax.vmap(
                    lambda k: jax.random.uniform(k, (), theta.dtype)
                )(kt) < jnp.exp(logw_new - total)
                samp = jnp.where(take[:, None], th, samp)
                samp_lp = jnp.where(take, lp, samp_lp)
                samp_g = jnp.where(take[:, None], g, samp_g)
                return (th, r, lp, g, total, samp, samp_lp, samp_g, key2,
                        sum_a), None

            (th_end, r_end, lp_end, g_end, logw_seg, samp_seg, samp_lp_seg,
             samp_g_seg, _, sum_a), _ = jax.lax.scan(
                leap,
                (th0, r0, lp0, g0,
                 jnp.full(C, -jnp.inf, theta.dtype),
                 th0, lp0, g0, ksel, jnp.zeros(C, theta.dtype)),
                None,
                length=n_sub,
            )

            theta_minus = jnp.where(gr, state["theta_minus"], th_end)
            r_minus = jnp.where(gr, state["r_minus"], -r_end)
            lp_minus = jnp.where(go_right, state["lp_minus"], lp_end)
            g_minus = jnp.where(gr, state["g_minus"], g_end)
            theta_plus = jnp.where(gr, th_end, state["theta_plus"])
            r_plus = jnp.where(gr, r_end, state["r_plus"])
            lp_plus = jnp.where(go_right, lp_end, state["lp_plus"])
            g_plus = jnp.where(gr, g_end, state["g_plus"])

            dtheta = theta_plus - theta_minus
            turned = (
                jnp.sum(dtheta * r_minus * inv_mass, axis=1) < 0
            ) | (jnp.sum(dtheta * r_plus * inv_mass, axis=1) < 0)
            diverged = logw_seg < -1000.0

            ks3 = jax.vmap(lambda k: jax.random.split(k, 2))(key_new)
            key_fin, kmerge = ks3[:, 0], ks3[:, 1]
            total = jnp.logaddexp(state["logw_sum"], logw_seg)
            take_new = jax.vmap(
                lambda k: jax.random.uniform(k, (), theta.dtype)
            )(kmerge) < jnp.exp(logw_seg - total)
            keep = (~(turned | diverged)) & active
            take = keep & take_new
            upd = active
            u1 = upd[:, None]

            def sel(cond1, a, b):
                return jnp.where(cond1, a, b)

            keep1 = keep[:, None]
            return {
                "theta_minus": sel(keep1, theta_minus, state["theta_minus"]),
                "r_minus": sel(keep1, r_minus, state["r_minus"]),
                "lp_minus": sel(keep, lp_minus, state["lp_minus"]),
                "g_minus": sel(keep1, g_minus, state["g_minus"]),
                "theta_plus": sel(keep1, theta_plus, state["theta_plus"]),
                "r_plus": sel(keep1, r_plus, state["r_plus"]),
                "lp_plus": sel(keep, lp_plus, state["lp_plus"]),
                "g_plus": sel(keep1, g_plus, state["g_plus"]),
                "sample": sel(take[:, None], samp_seg, state["sample"]),
                "sample_lp": sel(take, samp_lp_seg, state["sample_lp"]),
                "sample_g": sel(take[:, None], samp_g_seg,
                                state["sample_g"]),
                "logw_sum": sel(keep, total, state["logw_sum"]),
                "turned": jnp.where(upd, turned | diverged,
                                    state["turned"]),
                "sum_accept": state["sum_accept"]
                + jnp.where(upd, sum_a, 0.0),
                "n_steps": state["n_steps"]
                + jnp.where(upd, float(n_sub), 0.0),
                "key": sel(u1, key_fin, state["key"]),
            }

        return jax.lax.cond(
            jnp.all(state["turned"]), lambda s: s, do_extend, state
        )

    for level in range(max_depth):
        state = extend(level, state)

    accept_stat = state["sum_accept"] / jnp.maximum(state["n_steps"], 1.0)
    return (state["sample"], state["sample_lp"], state["sample_g"],
            key_out, accept_stat, state["n_steps"])


def nuts_chains(logdensity: Callable, inits, keys, num_samples: int = 1000,
                num_warmup: int = 500, max_depth: int = 6,
                initial_step: float = 0.1, target_accept: float = 0.8):
    """C chains of :func:`nuts` with the chain axis explicit (see
    :func:`_nuts_step_chains` for why this beats ``vmap(nuts)`` on
    accelerators). Per-chain warmup adaptation mirrors :func:`nuts`.
    ``inits``: (C, dim); ``keys``: (C, 2) PRNG keys. Returns
    (samples (C, num_samples, dim), info)."""
    vg_b = jax.vmap(jax.value_and_grad(logdensity))
    C, dim = inits.shape
    logp0, grad0 = vg_b(inits)

    def warmup_step(carry, _):
        theta, logp, grad, key, da, mean, m2, count = carry
        step = jnp.exp(da.log_step)
        inv_mass = jnp.where(
            count > 10.0,
            jnp.maximum(m2 / jnp.maximum(count - 1.0, 1.0), 1e-6),
            jnp.ones((C, dim), theta.dtype),
        )
        theta, logp, grad, key, accept, _n = _nuts_step_chains(
            vg_b, theta, logp, grad, key, step, inv_mass, max_depth
        )
        da = _da_update(da, accept, target=target_accept)
        count = count + 1.0
        delta = theta - mean
        mean = mean + delta / count
        m2 = m2 + delta * (theta - mean)
        return (theta, logp, grad, key, da, mean, m2, count), accept

    da0 = _da_init(jnp.full(C, initial_step, inits.dtype))
    carry = (
        inits, logp0, grad0, keys, da0,
        jnp.zeros((C, dim), inits.dtype),
        jnp.zeros((C, dim), inits.dtype),
        jnp.asarray(0.0, inits.dtype),
    )
    carry, warm_accept = jax.lax.scan(warmup_step, carry, None,
                                      length=num_warmup)
    theta, logp, grad, keys, da, mean, m2, count = carry
    step = jnp.exp(da.log_step_avg)
    inv_mass = jnp.maximum(m2 / jnp.maximum(count - 1.0, 1.0), 1e-6)

    def sample_step(carry, _):
        theta, logp, grad, key = carry
        theta, logp, grad, key, accept, nlf = _nuts_step_chains(
            vg_b, theta, logp, grad, key, step, inv_mass, max_depth
        )
        return (theta, logp, grad, key), (theta, accept, nlf)

    _, (samples, accepts, nlfs) = jax.lax.scan(
        sample_step, (theta, logp, grad, keys), None, length=num_samples
    )
    info = {
        "step_size": step,
        "accept_rate": jnp.mean(accepts, axis=0),
        "warmup_accept_rate": jnp.mean(warm_accept, axis=0),
        "inv_mass": inv_mass,
        # mean leapfrogs (= gradient evaluations) per kept sample — lets
        # benchmarks audit samples/s against the chip's raw gradient rate
        "mean_leapfrogs": jnp.mean(nlfs, axis=0),
    }
    return jnp.swapaxes(samples, 0, 1), info


def sample_chains(logdensity, init, key, num_chains: int = 4,
                  method: str = "nuts", **kwargs):
    """Multiple chains on one device; jitter the inits. NUTS chains run
    through the explicitly chain-batched :func:`nuts_chains` (whole
    doubling levels are skipped once every chain U-turns); HMC chains
    vmap."""
    keys = jax.random.split(key, num_chains)
    dim = init.shape[0]
    jitter = (
        0.1
        * jax.random.normal(
            jax.random.fold_in(key, 1), (num_chains, dim), init.dtype
        )
    )
    inits = init[None, :] + jitter
    if method == "nuts":
        return nuts_chains(logdensity, inits, keys, **kwargs)

    def run(i, k):
        return hmc(logdensity, i, k, **kwargs)

    return jax.vmap(run)(inits, keys)


def sample_chains_sharded(logdensity, init, key, mesh, axis: str = "data",
                          chains_per_device: int = 1, method: str = "hmc",
                          **kwargs):
    """Shard chains over a mesh axis: num_chains = axis size ×
    chains_per_device. Embarrassingly parallel across devices; the chains
    dimension is sharded, everything else replicated."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    n_shards = mesh.shape[axis]
    num_chains = n_shards * chains_per_device
    keys = jax.random.split(key, num_chains)
    dim = init.shape[0]
    jitter = 0.1 * jax.random.normal(
        jax.random.fold_in(key, 1), (num_chains, dim), init.dtype
    )
    inits = init[None, :] + jitter
    if method == "nuts":
        # run the CHAIN-BATCHED sampler per shard: each device advances its
        # chains_per_device chains together, skipping whole doubling levels
        # once every local chain U-turns (nuts_chains) — vmap(nuts) would
        # pay all 2^max_depth - 1 leapfrogs per transition per chain
        from ..parallel import shard_map

        key_spec = P(axis) if keys.ndim == 1 else P(axis, None)

        def run_shard(i, k):
            return nuts_chains(logdensity, i, k, **kwargs)

        out_specs = (
            P(axis, None, None),
            {
                "step_size": P(axis),
                "accept_rate": P(axis),
                "warmup_accept_rate": P(axis),
                "inv_mass": P(axis, None),
                "mean_leapfrogs": P(axis),
            },
        )
        # no collectives inside (chains are independent), so the varying-
        # manual-axes bookkeeping is unnecessary — and constant-initialized
        # scan carries inside nuts_chains trip its type check
        try:
            fn = shard_map(
                run_shard,
                mesh=mesh,
                in_specs=(P(axis, None), key_spec),
                out_specs=out_specs,
                check_vma=False,
            )
        except TypeError:  # older jax spelling
            fn = shard_map(
                run_shard,
                mesh=mesh,
                in_specs=(P(axis, None), key_spec),
                out_specs=out_specs,
                check_rep=False,
            )
        inits = jax.device_put(inits, NamedSharding(mesh, P(axis, None)))
        keys = jax.device_put(keys, NamedSharding(mesh, key_spec))
        return jax.jit(fn)(inits, keys)

    def run(i, k):
        return hmc(logdensity, i, k, **kwargs)

    sharding = NamedSharding(mesh, P(axis))
    inits = jax.device_put(inits, NamedSharding(mesh, P(axis, None)))
    keys = jax.device_put(keys, sharding)
    return jax.jit(jax.vmap(run))(inits, keys)
