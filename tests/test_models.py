"""Model-level shape/dtype/behavior tests, modeled on the reference's working
smoke test (ref: transformer_rawIQ/test_model.py:91-114): build, forward, shape
assert, softmax sanity, batch-size sweep."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitiq.config import ModelConfig
from vitiq.models import init_amc_params, make_forward, count_parameters


def tiny_vit(**kw):
    base = dict(num_classes=5, d_model=32, n_head=4, n_layers=2, ffn_hidden=64,
                drop_prob=0.1)
    base.update(kw)
    return ModelConfig(arm="vit", **base)


def tiny_rawiq(**kw):
    base = dict(num_classes=5, d_model=32, n_head=4, n_layers=2, ffn_hidden=64,
                drop_prob=0.1, seq_length=128, segment_size=16)
    base.update(kw)
    return ModelConfig(arm="rawiq", **base)


class TestViTArm:
    def test_forward_shape(self):
        cfg = tiny_vit()
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        fwd = jax.jit(make_forward(cfg))
        x = jnp.zeros((3, 1, 32, 64))
        logits = fwd(params, x)
        assert logits.shape == (3, 5)
        assert logits.dtype == jnp.float32

    def test_token_count(self):
        cfg = tiny_vit(patch_size=4)
        assert cfg.num_tokens == (32 // 4) * (64 // 4) + 1 == 129

    @pytest.mark.parametrize("batch", [1, 8, 16])
    def test_batch_sweep(self, batch):
        cfg = tiny_vit()
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        fwd = make_forward(cfg)
        logits = fwd(params, jnp.ones((batch, 1, 32, 64)))
        assert logits.shape == (batch, 5)

    def test_softmax_is_valid_distribution(self):
        cfg = tiny_vit()
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        fwd = make_forward(cfg)
        logits = fwd(params, jnp.asarray(np.random.default_rng(0).standard_normal((4, 1, 32, 64)), jnp.float32))
        probs = np.asarray(jax.nn.softmax(logits, axis=-1))
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
        assert (probs >= 0).all()

    def test_vit_head_has_no_pre_layernorm(self):
        cfg = tiny_vit()
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        assert "head_norm" not in params

    def test_deterministic_eval(self):
        cfg = tiny_vit()
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        fwd = make_forward(cfg)
        x = jnp.ones((2, 1, 32, 64))
        np.testing.assert_array_equal(np.asarray(fwd(params, x)), np.asarray(fwd(params, x)))

    def test_dropout_changes_train_output(self):
        cfg = tiny_vit()
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        fwd = make_forward(cfg)
        x = jnp.ones((2, 1, 32, 64))
        a = fwd(params, x, train=True, rng=jax.random.PRNGKey(1))
        b = fwd(params, x, train=True, rng=jax.random.PRNGKey(2))
        assert not np.allclose(np.asarray(a), np.asarray(b))


class TestRawIQArm:
    def test_forward_shape_segment(self):
        cfg = tiny_rawiq()
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        logits = jax.jit(make_forward(cfg))(params, jnp.zeros((3, 2, 128)))
        assert logits.shape == (3, 5)

    def test_forward_shape_conv1d(self):
        cfg = tiny_rawiq(embedding_type="conv1d")
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        logits = make_forward(cfg)(params, jnp.zeros((2, 2, 128)))
        assert logits.shape == (2, 5)
        assert cfg.num_tokens == 128 + 1

    def test_mean_pool_mode(self):
        cfg = tiny_rawiq(use_cls_token=False)
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        assert "cls_token" not in params["encoder"]
        logits = make_forward(cfg)(params, jnp.zeros((2, 2, 128)))
        assert logits.shape == (2, 5)

    def test_rawiq_head_has_pre_layernorm(self):
        cfg = tiny_rawiq()
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        assert "head_norm" in params

    def test_segment_token_count(self):
        # SEGMENT_SIZE=16 gives 1024/16 = 64 tokens (the reference's comment
        # claims 16 tokens — SURVEY.md §2.8 item 7 flags it as wrong)
        cfg = tiny_rawiq(seq_length=1024, segment_size=16)
        assert cfg.num_tokens == 64 + 1


class TestParamCounts:
    def test_reference_scale_param_counts(self):
        """README quotes ViT d128/L6 ~= 1.2M params (ref README.md:596-601)."""
        cfg = ModelConfig(arm="vit", num_classes=19, d_model=128, n_head=8,
                          n_layers=6, ffn_hidden=512, patch_size=4)
        n = count_parameters(init_amc_params(jax.random.PRNGKey(0), cfg))
        assert 1.1e6 < n < 1.3e6

    def test_rawiq_segment_scale(self):
        cfg = ModelConfig(arm="rawiq", num_classes=19, d_model=128, n_head=8,
                          n_layers=6, ffn_hidden=1024, segment_size=64)
        n = count_parameters(init_amc_params(jax.random.PRNGKey(0), cfg))
        assert 1.4e6 < n < 2.2e6


class TestConfigValidation:
    def test_d_model_head_divisibility(self):
        with pytest.raises(ValueError):
            ModelConfig(d_model=30, n_head=8).validate()

    def test_bad_embedding_type(self):
        with pytest.raises(ValueError):
            ModelConfig(arm="rawiq", embedding_type="magic").validate()

    def test_patch_divisibility(self):
        with pytest.raises(ValueError):
            ModelConfig(arm="vit", patch_size=5).validate()

    def test_json_roundtrip(self):
        from vitiq.config import ExperimentConfig
        cfg = ExperimentConfig.rawiq_reference()
        cfg2 = ExperimentConfig.from_json(cfg.to_json())
        assert cfg2.model == cfg.model
        assert cfg2.train == cfg.train
        assert cfg2.data == cfg.data

    def test_vit_tpu_production_preset(self):
        """The H2 preset (d_head=64 — the variant with the statistically-
        significant accuracy gate): reference ViT in every respect except
        n_head, and forward-compatible."""
        from vitiq.config import ExperimentConfig
        ref = ExperimentConfig.vit_reference()
        h2 = ExperimentConfig.vit_tpu_production()
        assert h2.model.n_head == 2
        assert h2.model.d_model == ref.model.d_model
        assert h2.model.n_layers == ref.model.n_layers
        h2.model.validate()
        params = init_amc_params(jax.random.PRNGKey(0), h2.model)
        x = jnp.asarray(np.random.default_rng(2).standard_normal(
            (2, 1, 32, 64)), jnp.float32)
        assert make_forward(h2.model)(params, x).shape == (2, 19)


class TestBf16NumericsPreset:
    def test_bf16_close_to_f32(self):
        cfg32 = tiny_vit(drop_prob=0.0)
        cfg16 = tiny_vit(drop_prob=0.0, numerics="tpu")
        params = init_amc_params(jax.random.PRNGKey(0), cfg32)
        x = jnp.asarray(np.random.default_rng(1).standard_normal((2, 1, 32, 64)), jnp.float32)
        ref = np.asarray(make_forward(cfg32)(params, x))
        bf16 = np.asarray(make_forward(cfg16)(params, x))
        # bf16 matmuls with f32 accumulation & LN: logits agree loosely
        np.testing.assert_allclose(ref, bf16, atol=0.15, rtol=0.1)
        assert np.mean(np.argmax(ref, -1) == np.argmax(bf16, -1)) >= 0.5


class TestRawiqBestPreset:
    """The reference's best published checkpoint geometry (rawIQ
    exp_L9_H8_F1024_W1e-3, 63.44%) must be available as a preset, match the
    reference's own persisted config.json field-for-field, and run through
    the framework (fused kernels are D-generic — interpreter-verified at
    d_model=256)."""

    REF_CFG = ("/root/reference/Transformer_Thesis/transformer_rawIQ/result/"
               "checkpoints/exp_L9_H8_F1024_W1e-3/config.json")

    def test_matches_reference_config_json(self):
        import json, os
        from vitiq.config import ExperimentConfig
        if not os.path.exists(self.REF_CFG):
            import pytest
            pytest.skip("reference checkpoint config not present")
        ref = json.loads(open(self.REF_CFG).read())
        cfg = ExperimentConfig.rawiq_best()
        m, t, d = cfg.model, cfg.train, cfg.data
        assert (m.d_model, m.n_head, m.n_layers, m.ffn_hidden) == (
            ref["D_MODEL"], ref["N_HEAD"], ref["N_LAYERS"], ref["FFN_HIDDEN"])
        assert m.drop_prob == ref["DROP_PROB"]
        assert m.embedding_type == ref["EMBEDDING_TYPE"]
        assert m.segment_size == ref["SEGMENT_SIZE"]
        assert m.use_cls_token == ref["USE_CLS_TOKEN"]
        assert m.seq_length == ref["SEQ_LENGTH"]
        assert t.batch_size == ref["BATCH_SIZE"]
        assert t.learning_rate == ref["LEARNING_RATE"]
        assert t.weight_decay == ref["WEIGHT_DECAY"]
        assert t.label_smoothing == ref["LABEL_SMOOTHING"]
        assert t.grad_clip_max_norm == ref["GRAD_CLIP_MAX_NORM"]
        assert t.patience == ref["PATIENCE"]
        assert t.save_freq == ref["SAVE_FREQ"]
        assert d.split_seed == ref["SPLIT_SEED"]
        assert d.norm_seed == ref["NORM_SEED"]
        assert d.train_size == ref["TRAIN_SIZE"]
        assert list(d.target_modulations) == ref["TARGET_MODULATIONS"]

    def test_forward(self):
        from vitiq.config import ExperimentConfig
        from vitiq.models import init_amc_params, make_forward
        cfg = ExperimentConfig.rawiq_best()
        cfg.model.validate()
        params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
        logits = jax.jit(make_forward(cfg.model))(
            params, jnp.zeros((2, 2, 1024)))
        assert logits.shape == (2, 19)
