"""Training-loop tests: end-to-end slice on synthetic data, scheduler/early-stop
semantics, checkpoint round-trips, and data-parallel equivalence on the
8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vitiq.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from vitiq.data import SyntheticAMCDataset
from vitiq.dsp import preprocess_batch_rawiq
from vitiq.models import init_amc_params, make_forward
from vitiq.train import (
    EarlyStopping,
    ReduceLROnPlateau,
    TrainState,
    create_train_state,
    fit,
    load_checkpoint,
    make_eval_step,
    make_train_step,
    save_checkpoint,
    get_learning_rate,
    set_learning_rate,
)
from vitiq.train.optim import make_optimizer
from vitiq.train.loop import evaluate_epoch
from vitiq.parallel import make_mesh


def tiny_experiment(num_epochs=3, batch_size=64, **model_kw):
    model = dict(arm="rawiq", num_classes=2, d_model=32, n_head=4, n_layers=2,
                 ffn_hidden=64, drop_prob=0.1, seq_length=128, segment_size=16)
    model.update(model_kw)
    return ExperimentConfig(
        model=ModelConfig(**model),
        data=DataConfig(source="synthetic", synthetic_classes=("BPSK", "QPSK")),
        train=TrainConfig(batch_size=batch_size, num_epochs=num_epochs,
                          learning_rate=1e-3, weight_decay=1e-4, patience=10),
    )


def tiny_data(n_per_class=256, frame_len=128, seed=0, classes=("BPSK", "QPSK")):
    ds = SyntheticAMCDataset(classes=classes, frames_per_class=n_per_class,
                             frame_len=frame_len, snrs_db=(20.0,), seed=seed)
    n = len(ds)
    split = int(0.8 * n)
    stats = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
    pre = lambda x: preprocess_batch_rawiq(x, stats)
    return (ds.X[:split], ds.Y[:split]), (ds.X[split:], ds.Y[split:]), pre


class TestEndToEndSlice:
    def test_learns_amc_from_amplitude_phase_features(self):
        """The minimum end-to-end slice (SURVEY.md §7.2 step 2): rawIQ-small on
        synthetic BPSK/16QAM with the amplitude/phase front-end generalizes
        well above chance within a few epochs. (Raw-I/Q features are
        second-order in the samples and need thousands of steps — the MDF
        amp/phase transform makes modulation order first-order-learnable, so
        CI can assert real generalization fast.)"""
        from vitiq.dsp import preprocess_batch_amplitude_phase
        cfg = tiny_experiment(num_epochs=4)
        train, valid, _ = tiny_data(n_per_class=512, classes=("BPSK", "16QAM"))
        fwd = make_forward(cfg.model)
        params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
        res = fit(cfg, fwd, params, train, valid,
                  preprocess_fn=preprocess_batch_amplitude_phase, verbose=False)
        assert res.epochs_run == 4
        assert res.history["train_loss"][-1] < res.history["train_loss"][0]
        assert res.history["val_acc"][-1] > 0.85
        assert res.best_params is not None

    def test_raw_iq_trains_stably(self):
        """Pure raw-I/Q slice: loss decreases and stays finite (convergence to
        high accuracy needs far more steps than CI allows)."""
        cfg = tiny_experiment(num_epochs=3)
        train, valid, pre = tiny_data()
        fwd = make_forward(cfg.model)
        params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
        res = fit(cfg, fwd, params, train, valid, preprocess_fn=pre, verbose=False)
        assert np.isfinite(res.history["train_loss"]).all()
        assert res.history["train_loss"][-1] < res.history["train_loss"][0]

    def test_vit_arm_slice(self):
        from vitiq.dsp import preprocess_batch_vit
        cfg = tiny_experiment(num_epochs=2)
        cfg.model = ModelConfig(arm="vit", num_classes=2, d_model=32, n_head=4,
                                n_layers=2, ffn_hidden=64, drop_prob=0.1,
                                img_size_h=16, img_size_w=16, patch_size=4)
        ds = SyntheticAMCDataset(classes=("BPSK", "QPSK"), frames_per_class=128,
                                 frame_len=128, snrs_db=(20.0,), seed=1)
        stats = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
        pre = lambda x: preprocess_batch_vit(x, stats, H=16, W=16)
        fwd = make_forward(cfg.model)
        params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
        res = fit(cfg, fwd, params, (ds.X[:192], ds.Y[:192]), (ds.X[192:], ds.Y[192:]),
                  preprocess_fn=pre, verbose=False)
        assert res.epochs_run == 2
        assert np.isfinite(res.history["train_loss"]).all()


class TestSchedulers:
    def test_plateau_reduces_after_patience(self):
        s = ReduceLROnPlateau(factor=0.5, patience=2)
        lr = 1.0
        lr = s.step(1.0, lr)   # best=1.0
        for _ in range(2):     # 2 bad epochs: no reduction yet
            lr = s.step(1.0, lr)
        assert lr == 1.0
        lr = s.step(1.0, lr)   # 3rd bad epoch (> patience): reduce
        assert lr == 0.5

    def test_plateau_relative_threshold(self):
        s = ReduceLROnPlateau(factor=0.5, patience=0, threshold=1e-4)
        lr = 1.0
        lr = s.step(1.0, lr)
        # 1e-5 relative improvement is below threshold => counts as bad
        lr = s.step(1.0 - 1e-5, lr)
        assert lr == 0.5

    def test_plateau_min_lr(self):
        s = ReduceLROnPlateau(factor=0.1, patience=0, min_lr=0.05)
        lr = s.step(1.0, 1.0)
        lr = s.step(2.0, lr)
        assert lr == pytest.approx(0.1)
        lr = s.step(3.0, lr)
        assert lr == pytest.approx(0.05)  # floored

    def test_early_stopping_patience(self):
        es = EarlyStopping(patience=3)
        assert not es(1.0)
        for i in range(2):
            assert not es(2.0)
        assert es(2.0)  # third consecutive non-improvement
        assert es.early_stop

    def test_early_stopping_snapshots_best(self):
        es = EarlyStopping(patience=5)
        p1 = {"w": jnp.ones(3)}
        es(1.0, p1)
        p2 = {"w": jnp.zeros(3)}
        es(2.0, p2)  # worse: keeps p1
        np.testing.assert_array_equal(np.asarray(es.best_params["w"]), np.ones(3))

    def test_lr_injection_no_structure_change(self):
        cfg = tiny_experiment().train
        model_cfg = tiny_experiment().model
        params = init_amc_params(jax.random.PRNGKey(0), model_cfg)
        state = create_train_state(params, cfg)
        assert get_learning_rate(state) == pytest.approx(1e-3)
        state2 = set_learning_rate(state, 5e-4)
        assert get_learning_rate(state2) == pytest.approx(5e-4)
        # same treedef: no recompile on the next step
        assert (jax.tree_util.tree_structure(state)
                == jax.tree_util.tree_structure(state2))


class TestEvalPadding:
    def test_partial_final_batch_scores_every_sample_once(self):
        cfg = tiny_experiment()
        fwd = make_forward(cfg.model)
        params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
        (x, y), _, pre = tiny_data(n_per_class=40)  # 64 train / 16 valid
        eval_step = make_eval_step(fwd, cfg.train.label_smoothing, pre)
        # batch 24 over 64 samples -> batches 24/24/16 (padded)
        m24 = evaluate_epoch(eval_step, params, x, y, 24)
        m64 = evaluate_epoch(eval_step, params, x, y, 64)
        assert m24["loss"] == pytest.approx(m64["loss"], rel=1e-5)
        assert m24["accuracy"] == pytest.approx(m64["accuracy"], rel=1e-6)


class TestCheckpoint:
    def test_roundtrip_identical(self, tmp_path):
        cfg = tiny_experiment()
        params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
        state = create_train_state(params, cfg.train)
        hist = {"val_loss": [1.0, 0.5]}
        save_checkpoint(tmp_path / "ckpt", state, epoch=2, val_loss=0.5,
                        history=hist, config=cfg)
        template = create_train_state(
            init_amc_params(jax.random.PRNGKey(1), cfg.model), cfg.train
        )
        restored, manifest = load_checkpoint(tmp_path / "ckpt", template)
        for a, b in zip(jax.tree_util.tree_leaves(state),
                        jax.tree_util.tree_leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert manifest["epoch"] == 2
        assert manifest["history"]["val_loss"] == [1.0, 0.5]
        assert manifest["config"]["model"]["arm"] == "rawiq"

    def test_structure_mismatch_fails_loudly(self, tmp_path):
        cfg = tiny_experiment()
        params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
        state = create_train_state(params, cfg.train)
        save_checkpoint(tmp_path / "ckpt", state, 0, 1.0, {}, cfg)
        other = tiny_experiment(batch_size=8)
        other.model.d_model = 64
        bad_template = create_train_state(
            init_amc_params(jax.random.PRNGKey(0), other.model), other.train
        )
        with pytest.raises(ValueError):
            load_checkpoint(tmp_path / "ckpt", bad_template)

    def test_resume_continues_training(self, tmp_path):
        cfg = tiny_experiment(num_epochs=2)
        train, valid, pre = tiny_data(n_per_class=128)
        fwd = make_forward(cfg.model)
        params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
        res1 = fit(cfg, fwd, params, train, valid, preprocess_fn=pre, verbose=False)
        save_checkpoint(tmp_path / "ck", res1.state, epoch=1,
                        val_loss=res1.history["val_loss"][-1],
                        history=res1.history, config=cfg)
        template = create_train_state(init_amc_params(jax.random.PRNGKey(9), cfg.model),
                                      cfg.train)
        state, manifest = load_checkpoint(tmp_path / "ck", template)
        cfg4 = tiny_experiment(num_epochs=4)
        res2 = fit(cfg4, fwd, None, train, valid, preprocess_fn=pre,
                   resume_state=state, resume_history=manifest["history"],
                   start_epoch=manifest["epoch"] + 1, verbose=False)
        assert len(res2.history["val_loss"]) == 4
        assert int(res2.state.step) > int(res1.state.step) > 0


class TestDataParallel:
    def test_dp8_matches_single_device_loss(self):
        """The same fit on a 1-device and an 8-device data mesh must produce
        (near-)identical trajectories: sharding only changes WHERE compute
        runs. CPU matmul reassociation allows tiny drift."""
        cfg1 = tiny_experiment(num_epochs=2, batch_size=64)
        cfg8 = tiny_experiment(num_epochs=2, batch_size=64)
        cfg8.train.data_parallel = 8
        train, valid, pre = tiny_data(n_per_class=128)
        fwd = make_forward(cfg1.model)
        params = init_amc_params(jax.random.PRNGKey(0), cfg1.model)
        r1 = fit(cfg1, fwd, params, train, valid, preprocess_fn=pre, verbose=False)
        r8 = fit(cfg8, fwd, params, train, valid, preprocess_fn=pre, verbose=False)
        np.testing.assert_allclose(r1.history["val_loss"], r8.history["val_loss"],
                                   rtol=2e-3)
        np.testing.assert_allclose(r1.history["train_loss"], r8.history["train_loss"],
                                   rtol=2e-3)

    def test_tensor_parallel_forward_matches(self):
        """TP over the 'model' axis is numerically the same computation."""
        from vitiq.parallel import shard_params, shard_batch
        cfg = tiny_experiment().model
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        fwd = make_forward(cfg)
        x = jnp.asarray(np.random.default_rng(0).standard_normal((8, 2, 128)), jnp.float32)
        ref = np.asarray(fwd(params, x))
        mesh = make_mesh(data=2, model=4)
        with mesh:
            p_sharded = shard_params(params, mesh)
            x_sharded = shard_batch(x, mesh)
            got = np.asarray(jax.jit(fwd)(p_sharded, x_sharded))
        np.testing.assert_allclose(ref, got, atol=2e-5)


def test_dispatch_sync_does_not_change_trajectory():
    """dispatch_sync_steps (the async-dispatch depth bound that keeps RSS
    bounded on out-of-core runs) is a pure scheduling knob: syncing every
    step vs never must produce the identical training trajectory."""
    cfg_a = tiny_experiment(num_epochs=2)
    cfg_a.train.dispatch_sync_steps = 1
    cfg_b = tiny_experiment(num_epochs=2)
    cfg_b.train.dispatch_sync_steps = 0
    train, valid, pre = tiny_data(n_per_class=128)
    fwd = make_forward(cfg_a.model)
    params = init_amc_params(jax.random.PRNGKey(0), cfg_a.model)
    ra = fit(cfg_a, fwd, params, train, valid, preprocess_fn=pre, verbose=False)
    rb = fit(cfg_b, fwd, params, train, valid, preprocess_fn=pre, verbose=False)
    np.testing.assert_allclose(ra.history["train_loss"], rb.history["train_loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(ra.history["val_loss"], rb.history["val_loss"],
                               rtol=1e-6)


def test_device_scan_superbatching_matches_per_batch_trajectory():
    """device_scan_steps (K train steps fused into one lax.scan device
    call, collapsing per-step dispatch cost) is a
    pure dispatch transform: the training trajectory must match the
    per-batch path exactly, including the ragged tail that falls back to
    single steps (410 train rows / batch 64 = 6 batches = one scan-4 group
    + 2 singles)."""
    cfg_a = tiny_experiment(num_epochs=2)
    cfg_b = tiny_experiment(num_epochs=2)
    cfg_b.train.device_scan_steps = 4
    train, valid, pre = tiny_data(n_per_class=256)
    fwd = make_forward(cfg_a.model)
    params = init_amc_params(jax.random.PRNGKey(0), cfg_a.model)
    ra = fit(cfg_a, fwd, params, train, valid, preprocess_fn=pre, verbose=False)
    rb = fit(cfg_b, fwd, params, train, valid, preprocess_fn=pre, verbose=False)
    np.testing.assert_allclose(ra.history["train_loss"], rb.history["train_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(ra.history["val_loss"], rb.history["val_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(ra.history["val_acc"], rb.history["val_acc"],
                               rtol=1e-5)


def test_device_scan_superbatching_on_mesh():
    """Round 5 (VERDICT r4 item 5): device-scan superbatching must compose
    with a data-parallel mesh — the stacked [K, B, ...] superbatch is placed
    with scan_batch_sharding (K unsharded, B over 'data') and the training
    trajectory must match the per-batch mesh path exactly."""
    cfg_a = tiny_experiment(num_epochs=2)
    cfg_a.train.data_parallel = 4
    cfg_a.train.device_scan_steps = 0
    cfg_b = tiny_experiment(num_epochs=2)
    cfg_b.train.data_parallel = 4
    cfg_b.train.device_scan_steps = 4
    train, valid, pre = tiny_data(n_per_class=256)
    fwd = make_forward(cfg_a.model)
    params = init_amc_params(jax.random.PRNGKey(0), cfg_a.model)
    ra = fit(cfg_a, fwd, params, train, valid, preprocess_fn=pre, verbose=False)
    rb = fit(cfg_b, fwd, params, train, valid, preprocess_fn=pre, verbose=False)
    np.testing.assert_allclose(ra.history["train_loss"], rb.history["train_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(ra.history["val_loss"], rb.history["val_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(ra.history["val_acc"], rb.history["val_acc"],
                               rtol=1e-5)


def test_superbatches_flushes_on_shape_mismatch():
    """ADVICE r4: a shape-mismatched batch mid-epoch must flush the group in
    progress as singles and keep grouping afterwards — never accumulate the
    rest of the epoch in host RAM."""
    import numpy as _np

    from vitiq.train.loop import superbatches

    b = _np.zeros((4, 8, 2), _np.float32)
    y = _np.zeros((4,), _np.int64)
    odd = b[:, :4, :]

    def gen():
        for _ in range(3):
            yield b, y
        yield odd, y  # shape change mid-group
        for _ in range(4):
            yield b, y

    items = list(superbatches(gen(), 4))
    kinds = [it[0] for it in items]
    # the 3 buffered full-shape batches flush as singles at the mismatch;
    # the odd batch flushes when the next full-shape batch arrives; the 4
    # trailing full-shape batches then form one scan group
    assert kinds == ["single", "single", "single", "single", "scan"]
    assert items[3][1].shape == odd.shape
    assert items[4][1].shape == (4,) + b.shape
    # every input batch is delivered exactly once
    assert sum(1 if k == "single" else 4 for k in kinds) == 8
    # the per-step dropout key (fold_in of the step counter, as the train
    # step derives it) is deterministic per (seed, step) and differs
    # between steps
    import jax
    import jax.numpy as jnp
    from vitiq.config import ModelConfig
    from vitiq.models import init_amc_params, make_forward

    cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=32, n_head=4,
                      n_layers=1, ffn_hidden=64, seq_length=64,
                      segment_size=16, drop_prob=0.3)
    params = init_amc_params(jax.random.PRNGKey(0), cfg)
    fwd = make_forward(cfg)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 2, 64)),
                    jnp.float32)
    k1 = jax.random.fold_in(jax.random.PRNGKey(1), 0)
    k1b = jax.random.fold_in(jax.random.PRNGKey(1), 0)
    k2 = jax.random.fold_in(jax.random.PRNGKey(1), 1)
    a = fwd(params, x, train=True, rng=k1)
    b = fwd(params, x, train=True, rng=k1b)
    c = fwd(params, x, train=True, rng=k2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.allclose(np.asarray(a), np.asarray(c))
    assert np.isfinite(np.asarray(a)).all()
