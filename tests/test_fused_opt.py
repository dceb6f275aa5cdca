"""Flat fused clip+AdamW (vitiq/train/optim.py) equivalence vs the per-leaf
optax chain it replaces, plus the injected-LR interface it must preserve."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from vitiq.config import TrainConfig
from vitiq.train.optim import (
    create_train_state,
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)


def _tree(seed, scale=1.0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    return {
        "a": {"kernel": jax.random.normal(ks[0], (7, 5)) * scale,
              "bias": jax.random.normal(ks[1], (5,)) * scale},
        "b": [jax.random.normal(ks[2], (3, 3)) * scale,
              jax.random.normal(ks[3], (2,)) * scale],
    }


def _optax_chain(cfg):
    """The per-leaf optax chain the fused form replaces (the reference)."""
    return optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip_max_norm),
        optax.adamw(learning_rate=learning_rate, b1=cfg.adam_b1,
                    b2=cfg.adam_b2, eps=cfg.adam_eps,
                    weight_decay=cfg.weight_decay)))(
        learning_rate=cfg.learning_rate)


@pytest.mark.parametrize("gscale", [0.01, 50.0])  # below / above the clip norm
def test_fused_matches_optax_chain(gscale):
    cfg = TrainConfig(learning_rate=3e-3, weight_decay=1e-2)
    params = _tree(0)

    trajectories = []
    for tx in (make_optimizer(cfg), _optax_chain(cfg)):
        p = params
        st = tx.init(p)
        steps = []
        for i in range(5):
            grads = _tree(100 + i, scale=gscale)
            upd, st = tx.update(grads, st, p)
            p = optax.apply_updates(p, upd)
            steps.append(p)
        trajectories.append(steps)
    for pf, pc in zip(*trajectories):
        fa, _ = jax.flatten_util.ravel_pytree(pf)
        ca, _ = jax.flatten_util.ravel_pytree(pc)
        np.testing.assert_allclose(np.asarray(fa), np.asarray(ca),
                                   atol=1e-6, rtol=1e-5)


def test_injected_lr_interface():
    cfg = TrainConfig(learning_rate=1e-4)
    state = create_train_state(_tree(1), cfg)
    assert get_learning_rate(state) == pytest.approx(1e-4)
    state = set_learning_rate(state, 5e-5)
    assert get_learning_rate(state) == pytest.approx(5e-5)
    # the new LR must actually change the update magnitude
    tx = make_optimizer(cfg)
    grads = _tree(2)
    upd_lo, _ = tx.update(grads, state.opt_state, state.params)
    state_hi = set_learning_rate(state, 1e-2)
    upd_hi, _ = tx.update(grads, state_hi.opt_state, state_hi.params)
    lo, _ = jax.flatten_util.ravel_pytree(upd_lo)
    hi, _ = jax.flatten_util.ravel_pytree(upd_hi)
    np.testing.assert_allclose(np.asarray(hi), np.asarray(lo) * 200.0,
                               rtol=1e-5)
