"""Optimizer and train state.

Reproduces the reference's optimization recipe exactly (ref:
ViT/training/train.py:405-424): AdamW(lr, weight_decay, betas=(0.9, 0.99)),
global-norm gradient clipping at 1.0, label-smoothed cross-entropy — but as a
single optax chain inside one jitted step.

The learning rate is a DONATED STATE SCALAR (via optax.inject_hyperparams),
not a compile-time constant: the host-side ReduceLROnPlateau mutates it
between epochs without triggering recompilation (SURVEY.md §7.3 "host-side
schedulers inside an ahead-of-time-compiled world").
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp
import optax

from vitiq.config import TrainConfig


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jnp.ndarray  # int32 scalar


class FusedAdamWState(NamedTuple):
    count: jnp.ndarray  # int32 scalar
    mu: jnp.ndarray  # [P] first moment, flat over the param tree
    nu: jnp.ndarray  # [P] second moment, flat


def _fused_clip_adamw(cfg: TrainConfig, learning_rate) -> optax.GradientTransformation:
    """clip-by-global-norm -> AdamW computed on ONE raveled vector.

    Mathematically identical to optax.chain(clip_by_global_norm, adamw)
    over the same tree (the global norm is the norm of the concatenation;
    AdamW is elementwise), but ~10 vector ops instead of ~8 ops PER LEAF.
    The per-leaf chain's cost is op count, independent of parameter count
    (vit_tiny's 200K and seg-64 mp's 1.2M params cost the same); the flat
    form removes that."""
    from jax.flatten_util import ravel_pytree

    def init(params):
        flat, _ = ravel_pytree(params)
        return FusedAdamWState(
            count=jnp.zeros((), jnp.int32),
            mu=jnp.zeros_like(flat),
            nu=jnp.zeros_like(flat),
        )

    def update(grads, state, params):
        gflat, unravel = ravel_pytree(grads)
        pflat, _ = ravel_pytree(params)
        gnorm = jnp.sqrt(jnp.sum(jnp.square(gflat)))
        scale = jnp.minimum(1.0, cfg.grad_clip_max_norm / (gnorm + 1e-16))
        g = gflat * scale
        count = state.count + 1
        mu = cfg.adam_b1 * state.mu + (1.0 - cfg.adam_b1) * g
        nu = cfg.adam_b2 * state.nu + (1.0 - cfg.adam_b2) * jnp.square(g)
        c = count.astype(jnp.float32)
        mhat = mu / (1.0 - jnp.power(cfg.adam_b1, c))
        vhat = nu / (1.0 - jnp.power(cfg.adam_b2, c))
        upd = -learning_rate * (
            mhat / (jnp.sqrt(vhat) + cfg.adam_eps) + cfg.weight_decay * pflat)
        return unravel(upd), FusedAdamWState(count=count, mu=mu, nu=nu)

    return optax.GradientTransformation(init, update)


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    """clip-by-global-norm -> AdamW in the flat fused form, with injectable
    learning_rate (tests/test_fused_opt.py pins it to the per-leaf optax
    chain)."""
    return optax.inject_hyperparams(
        lambda learning_rate: _fused_clip_adamw(cfg, learning_rate))(
            learning_rate=cfg.learning_rate)


def create_train_state(params, cfg: TrainConfig) -> TrainState:
    tx = make_optimizer(cfg)
    return TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))


def get_learning_rate(state: TrainState) -> float:
    return float(state.opt_state.hyperparams["learning_rate"])


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Host-side LR mutation between epochs (no recompile: lr is state)."""
    hyper = dict(state.opt_state.hyperparams)
    hyper["learning_rate"] = jnp.asarray(lr, jnp.float32)
    opt_state = state.opt_state._replace(hyperparams=hyper)
    return state._replace(opt_state=opt_state)
