"""SIR particle filter for neighbor-state estimation, fully batched.

Reference parity: ``particle_filter/src/detail/particle_filter.cpp``
(init :12-56, predict :63-83, update :85-104, resample :106-118,
estimateState/getDistribution) and ``pf_applications.cpp:8-45``
(processFovUpdate: predict -> FOV negative-information down-weighting ->
conditional measurement update -> resample -> mean/cov).

Batch-first changes:
- filter state is a pytree of arrays; every step vmaps over (agent, target)
  pairs and scans over time,
- multinomial std::discrete_distribution resampling becomes *systematic*
  resampling (sort-free: one cumsum + one searchsorted), the standard
  variance-reduced choice,
- the FOV visibility branch becomes a weight blend (branch-free).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from mpc_cbf_tpu.types import Array
from mpc_cbf_tpu.ops.geometry import inside_fov


@dataclasses.dataclass(frozen=True)
class PFParams:
    num_particles: int = 256
    dt: float = 0.2  # particle_filter.cpp:19 (hard-coded dt)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PFState:
    """particles [..., P, D]; weights [..., P] (normalized)."""

    particles: Array
    weights: Array

    def tree_flatten(self):
        return (self.particles, self.weights), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)


def pf_init(key: Array, init_state: Array, init_cov: Array, params: PFParams) -> PFState:
    """Sample P particles from N(init_state, init_cov) via Cholesky
    (particle_filter.cpp:36-48)."""
    D = init_state.shape[-1]
    L = jnp.linalg.cholesky(init_cov)
    eps = jax.random.normal(key, (params.num_particles, D), init_state.dtype)
    particles = init_state + eps @ L.T
    w = jnp.full((params.num_particles,), 1.0 / params.num_particles, init_state.dtype)
    return PFState(particles=particles, weights=w)


def pf_predict(key: Array, st: PFState, process_cov_chol: Array, params: PFParams,
               u: Array | None = None) -> PFState:
    """x += u dt + W eps (particle_filter.cpp:63-83; W multiplies standard
    normals, so pass the reference's W matrix directly)."""
    P, D = st.particles.shape[-2:]
    noise = jax.random.normal(key, st.particles.shape, st.particles.dtype) @ process_cov_chol.T
    drift = 0.0 if u is None else u * params.dt
    return PFState(particles=st.particles + drift + noise, weights=st.weights)


def pf_update(st: PFState, measurement: Array, meas_cov: Array) -> PFState:
    """Gaussian likelihood re-weighting (particle_filter.cpp:85-104)."""
    innov = st.particles - measurement
    Pinv = jnp.linalg.inv(meas_cov)
    d2 = jnp.einsum("pi,ij,pj->p", innov, Pinv, innov)
    w = jnp.exp(-0.5 * d2)
    w = w / jnp.maximum(jnp.sum(w), 1e-30)
    return PFState(particles=st.particles, weights=w)


def pf_resample(key: Array, st: PFState) -> PFState:
    """Systematic resampling (replaces discrete_distribution,
    particle_filter.cpp:106-118)."""
    P = st.weights.shape[-1]
    cum = jnp.cumsum(st.weights)
    cum = cum / cum[-1]
    u0 = jax.random.uniform(key, (), st.weights.dtype) / P
    pts = u0 + jnp.arange(P, dtype=st.weights.dtype) / P
    idx = jnp.searchsorted(cum, pts)
    idx = jnp.clip(idx, 0, P - 1)
    return PFState(
        particles=st.particles[idx],
        weights=jnp.full((P,), 1.0 / P, st.weights.dtype),
    )


def pf_estimate(st: PFState) -> Tuple[Array, Array]:
    """(mean, cov). The reference estimates with the *unweighted* particle
    mean/cov post-resampling (particle_filter.cpp:121-125, 158-175)."""
    mean = jnp.mean(st.particles, axis=-2)
    diff = st.particles - mean
    P = st.particles.shape[-2]
    cov = diff.T @ diff / (P - 1)
    return mean, cov


def process_fov_update(
    key: Array, st: PFState, ego_pose: Array, neighbor_pos: Array,
    process_cov_chol: Array, meas_cov: Array, fov_beta: float, fov_rs: float,
    params: PFParams, weight_reduction: float = 10.0,
):
    """One estimator tick (pf_applications.cpp:8-45):

    1. predict,
    2. down-weight particles inside the ego FOV (negative information:
       if the target were there, we'd have seen it),
    3. if the true neighbor is visible, Gaussian measurement update,
    4. systematic resample, 5. mean/cov estimate.

    Returns (new_state, mean, cov). Branch-free: the conditional update is
    a weight blend on `visible`.

    Deliberate deviation: the reference's ``filter.update`` REPLACES the
    weights with the pure measurement likelihood
    (particle_filter.cpp:85-100), silently discarding the FOV
    down-weighting applied two lines earlier when the target is visible.
    Here the likelihood MULTIPLIES the FOV-adjusted weights (the Bayesian
    composition); for particles clustered near a visible measurement the
    uniform 1/weight_reduction factor cancels in normalization, so the
    behaviors coincide except for particles straddling the FOV boundary,
    where the multiplicative form retains strictly more information.
    """
    k1, k2 = jax.random.split(key)
    st = pf_predict(k1, st, process_cov_chol, params)

    in_fov = inside_fov(ego_pose, st.particles, fov_beta, fov_rs)
    w = jnp.where(in_fov, st.weights / weight_reduction, st.weights)

    visible = inside_fov(ego_pose, neighbor_pos, fov_beta, fov_rs)
    innov = st.particles - neighbor_pos[:2]
    Pinv = jnp.linalg.inv(meas_cov)
    d2 = jnp.einsum("pi,ij,pj->p", innov, Pinv, innov)
    w_meas = w * jnp.exp(-0.5 * d2)
    w = jnp.where(visible, w_meas, w)
    w = w / jnp.maximum(jnp.sum(w), 1e-30)

    st = PFState(particles=st.particles, weights=w)
    st = pf_resample(k2, st)
    mean, cov = pf_estimate(st)
    return st, mean, cov
