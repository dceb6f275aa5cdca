"""bf16 production numerics vs the f32 reference at every benchable
geometry (vitiq.bench.ARM_CONFIGS), at reduced depth and batch.

Eval logits and train-step gradients, through the unfused preprocess path
and the fused raw-frame embedding. On the card chip_smoke.py checks the
same pair at full depth (numerics b)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitiq.bench import ARM_CONFIGS, FLAGSHIP_STATS
from vitiq.dsp import preprocess_batch_rawiq, preprocess_batch_vit
from vitiq.models import init_amc_params, make_forward
from vitiq.ops.metrics import label_smoothed_cross_entropy

# max |dlogit| / max |logit|. One layer at initial weights carries less bf16
# rounding than the six trained layers chip_smoke.py bounds on the card
# (chip_smoke.BF16_REL), so this CPU bound is tighter.
LOGIT_REL = 3e-2
GRAD_REL_L2 = 0.1  # ||g_bf16 - g_f32|| / ||g_f32||
GRAD_COS = 0.999


@functools.lru_cache(maxsize=None)
def _setup(arm):
    cfg = dataclasses.replace(ARM_CONFIGS[arm]("reference"), n_layers=1,
                              drop_prob=0.0)
    params = init_amc_params(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (4, cfg.seq_length, 2)), jnp.float32)
    y = jnp.arange(4) % cfg.num_classes
    return cfg, params, x, y


def _outputs(arm, numerics, raw):
    cfg, params, x, y = _setup(arm)
    cfg = dataclasses.replace(cfg, numerics=numerics)
    fwd = make_forward(cfg, raw_stats=FLAGSHIP_STATS if raw else None)
    if raw:
        pre = lambda f: f
    elif cfg.arm == "vit":
        pre = lambda f: preprocess_batch_vit(f, FLAGSHIP_STATS,
                                             H=cfg.img_size_h, W=cfg.img_size_w)
    else:
        pre = lambda f: preprocess_batch_rawiq(f, FLAGSHIP_STATS)

    def loss(p):
        logits = fwd(p, pre(x), train=True, rng=jax.random.PRNGKey(1))
        return label_smoothed_cross_entropy(logits, y, 0.1)

    logits = jax.jit(lambda p: fwd(p, pre(x), train=False))(params)
    grads = jax.jit(jax.grad(loss))(params)
    flat = np.concatenate([np.asarray(g, np.float64).ravel()
                           for g in jax.tree_util.tree_leaves(grads)])
    return np.asarray(logits), flat


_reference = functools.lru_cache(maxsize=None)(
    lambda arm: _outputs(arm, "reference", raw=False))


@pytest.mark.parametrize("raw", [False, True], ids=["preprocess", "raw_embed"])
@pytest.mark.parametrize("arm", sorted(ARM_CONFIGS))
class TestBf16VsReference:
    def test_eval_logits(self, arm, raw):
        want, _ = _reference(arm)
        got, _ = _outputs(arm, "tpu", raw)
        assert got.shape == want.shape and np.isfinite(got).all()
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= LOGIT_REL, rel

    def test_train_step_gradients(self, arm, raw):
        _, want = _reference(arm)
        _, got = _outputs(arm, "tpu", raw)
        assert np.isfinite(got).all()
        cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert cos >= GRAD_COS and rel <= GRAD_REL_L2, (cos, rel)
