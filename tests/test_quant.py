"""Int8 W8A8 quantized serving path: numerics and end-to-end accuracy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitiq.config import ModelConfig
from vitiq.models import init_amc_params, make_forward
from vitiq.models.layers import linear_init
from vitiq.ops.quant import (
    int8_linear,
    make_quantized_forward,
    quantize_linear_params,
    quantize_params_int8,
)


class TestInt8Linear:
    def test_close_to_float(self):
        rng = np.random.default_rng(0)
        lin = linear_init(jax.random.PRNGKey(0), 64, 32)
        x = jnp.asarray(rng.standard_normal((8, 64)), jnp.float32)
        want = np.asarray(x @ lin["kernel"] + lin["bias"])
        got = np.asarray(int8_linear(quantize_linear_params(lin), x))
        # int8 dynamic quant: ~1% relative error at these widths
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 0.03, err

    def test_per_channel_scales(self):
        lin = {"kernel": jnp.asarray([[1.0, 100.0], [-1.0, -100.0]]),
               "bias": jnp.zeros(2)}
        q = quantize_linear_params(lin)
        np.testing.assert_allclose(np.asarray(q["scale"]), [1 / 127, 100 / 127])
        assert q["kernel_q"].dtype == jnp.int8
        np.testing.assert_array_equal(np.asarray(q["kernel_q"]),
                                      [[127, 127], [-127, -127]])

    def test_batched_rank3(self):
        rng = np.random.default_rng(1)
        lin = linear_init(jax.random.PRNGKey(1), 32, 16)
        x = jnp.asarray(rng.standard_normal((2, 5, 32)), jnp.float32)
        got = int8_linear(quantize_linear_params(lin), x)
        assert got.shape == (2, 5, 16)


class TestQuantizedModel:
    def make(self, arm="rawiq"):
        if arm == "rawiq":
            cfg = ModelConfig(arm="rawiq", num_classes=4, d_model=64, n_head=4,
                              n_layers=2, ffn_hidden=128, drop_prob=0.0,
                              seq_length=128, segment_size=16)
            x = jnp.asarray(np.random.default_rng(2).standard_normal((8, 2, 128)),
                            jnp.float32)
        else:
            cfg = ModelConfig(arm="vit", num_classes=4, d_model=64, n_head=4,
                              n_layers=2, ffn_hidden=128, drop_prob=0.0,
                              patch_size=4)
            x = jnp.asarray(np.random.default_rng(2).standard_normal((8, 1, 32, 64)),
                            jnp.float32)
        params = init_amc_params(jax.random.PRNGKey(3), cfg)
        return cfg, params, x

    @pytest.mark.parametrize("arm", ["rawiq", "vit"])
    def test_argmax_agreement(self, arm):
        cfg, params, x = self.make(arm)
        ref = np.asarray(make_forward(cfg)(params, x))
        qparams = quantize_params_int8(params)
        got = np.asarray(jax.jit(make_quantized_forward(cfg))(qparams, x))
        assert got.shape == ref.shape
        agreement = np.mean(ref.argmax(-1) == got.argmax(-1))
        assert agreement >= 0.875  # 7/8 on random (untrained) logits
        # logits stay in the same ballpark
        assert np.abs(got - ref).max() < 0.35 * max(np.abs(ref).max(), 1.0)

    def test_rawiq_head_norm_eps_matches_float_path(self):
        """The rawiq pre-head LayerNorm must run at torch's eps=1e-5 in BOTH
        paths (vitiq/models/amc.py:75 vs ops/quant.py). Regression test for
        the round-2 finding: scale the last layer's norm2 gamma to 1e-4 so
        the pre-head features have variance ~1e-8 — at that scale eps=1e-5
        vs eps=1e-12 changes the normalized features by ~30x, so any eps
        mismatch blows the comparison apart (int8 error alone is a few %)."""
        cfg, params, x = self.make("rawiq")
        g = params["encoder"]["layers"][-1]["norm2"]
        params = jax.tree_util.tree_map(lambda t: t, params)
        params["encoder"]["layers"][-1]["norm2"] = {
            "gamma": g["gamma"] * 1e-4, "beta": jnp.zeros_like(g["beta"])}
        ref = np.asarray(make_forward(cfg)(params, x))
        qparams = quantize_params_int8(params)
        got = np.asarray(jax.jit(make_quantized_forward(cfg))(qparams, x))
        scale = max(np.abs(ref).max(), 1e-3)
        assert np.abs(got - ref).max() < 0.35 * scale, (
            np.abs(got - ref).max(), scale)

    def test_head_stays_float(self):
        cfg, params, _ = self.make()
        qparams = quantize_params_int8(params)
        assert set(qparams["mlp_head"]) == {"kernel", "bias"}
        assert "kernel_q" in qparams["encoder"]["layers"][0]["attention"]["w_q"]

    def test_trained_model_accuracy_preserved(self):
        """Quantize a model trained on the amp/phase task: accuracy within
        2 points of the float model."""
        from vitiq.config import DataConfig, ExperimentConfig, TrainConfig
        from vitiq.data import SyntheticAMCDataset
        from vitiq.dsp import preprocess_batch_amplitude_phase
        from vitiq.train import fit

        cfg = ExperimentConfig(
            model=ModelConfig(arm="rawiq", num_classes=2, d_model=32, n_head=4,
                              n_layers=2, ffn_hidden=64, drop_prob=0.1,
                              seq_length=128, segment_size=16),
            data=DataConfig(source="synthetic"),
            train=TrainConfig(batch_size=64, num_epochs=5, learning_rate=1e-3),
        )
        ds = SyntheticAMCDataset(classes=("BPSK", "16QAM"), frames_per_class=512,
                                 frame_len=128, snrs_db=(20.0,), seed=0)
        split = int(0.8 * len(ds))
        fwd = make_forward(cfg.model)
        params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
        res = fit(cfg, fwd, params, (ds.X[:split], ds.Y[:split]),
                  (ds.X[split:], ds.Y[split:]),
                  preprocess_fn=preprocess_batch_amplitude_phase, verbose=False)

        xv = preprocess_batch_amplitude_phase(jnp.asarray(ds.X[split:]))
        yv = ds.Y[split:]
        float_acc = np.mean(np.asarray(fwd(res.best_params, xv)).argmax(-1) == yv)
        qfwd = make_quantized_forward(cfg.model)
        qparams = quantize_params_int8(res.best_params)
        q_acc = np.mean(np.asarray(qfwd(qparams, xv)).argmax(-1) == yv)
        assert float_acc > 0.8
        assert q_acc >= float_acc - 0.02, (float_acc, q_acc)
