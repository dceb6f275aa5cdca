"""chip_smoke.py's phases at tiny sizes on the CPU (the kernel in interpret
mode), and its refusal to report anything off a GPU."""

import dataclasses
import json

import jax
import numpy as np
import pytest

import chip_smoke as cs

TINY = ["--n_layers", "1", "--d_model", "32", "--n_head", "4",
        "--ffn_hidden", "64", "--batch_size", "32"]


@pytest.fixture
def work(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # `vitiq train` writes result/ here
    return tmp_path


def test_main_refuses_a_host_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert "ok" not in capsys.readouterr().out


def test_main_refuses_bad_device_count():
    with pytest.raises(SystemExit):
        cs.main(["--devices", "2"])


@pytest.mark.parametrize("arm,preset", cs.ARMS)
def test_train_evaluate_export_serve(work, arm, preset):
    checks = cs.Checks()
    run = cs.train_evaluate_export(checks, preset, work, 8, TINY)
    manifest = json.loads((run["artifact"] / "manifest.json").read_text())
    assert manifest["batch_sizes"] == [64, 256]
    assert manifest["platforms"] == ["cpu"]
    assert (run["exp_dir"] / "evaluation" /
            "test_classification_report.txt").exists()
    cs.serve_requests(checks, run["artifact"], run["exp_dir"], sizes=(1, 65))
    assert checks.failed == []


@pytest.mark.parametrize("arm", ["vit", "rawiq"])
def test_reference_vs_host_is_exact_on_cpu(arm):
    from vitiq.bench import ARM_CONFIGS

    cfg = dataclasses.replace(ARM_CONFIGS[arm]("tpu"), n_layers=1)
    res = cs.reference_vs_host(cfg, batch=2)
    assert set(res) == {"preprocess", "raw_embed"}
    assert all(v <= cs.REFERENCE_HOST_REL for v in res.values()), res


def _tiny_rawiq(frames):
    from vitiq.config import ExperimentConfig
    from vitiq.models import init_amc_params

    cfg = ExperimentConfig.rawiq_synthetic19()
    cfg.model = dataclasses.replace(cfg.model, n_layers=1, d_model=32,
                                    n_head=4, ffn_hidden=64)
    params = init_amc_params(jax.random.PRNGKey(0), cfg.model)
    stats = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
    x = np.random.default_rng(0).standard_normal(
        (frames, 1024, 2)).astype(np.float32)
    return cfg, params, stats, x


def test_bf16_vs_reference_reports_agreement():
    res = cs.bf16_vs_reference(*_tiny_rawiq(16))
    assert res["rel"] <= cs.BF16_REL
    assert res["argmax_agreement"] >= cs.BF16_ARGMAX
    # no kernel on the CPU: production bf16 is the plain-attention path
    assert res["kernel_argmax_cost"] == 0.0
    assert res["plain_argmax_agreement"] == res["argmax_agreement"]


def test_bf16_vs_reference_sees_a_broken_attention(monkeypatch):
    """A production attention with a sign error (and no use of the scores)
    fails both the relative bound and the kernel's agreement bound."""
    from vitiq.ops.pallas import flash_attention as fa

    def broken(q, k, v, n_head, mask=None, policy=None, return_scores=False):
        return policy.cast_compute(-3 * v)

    broken.packed_layout = True
    monkeypatch.setattr(fa, "fused_attention", broken)
    res = cs.bf16_vs_reference(*_tiny_rawiq(256))
    assert res["rel"] > cs.BF16_REL
    assert res["kernel_argmax_cost"] > cs.KERNEL_ARGMAX_COST


@pytest.mark.parametrize("shape", cs.ATTENTION_SHAPES,
                         ids=[f"L{L}-D{D}-H{H}" for L, D, H in cs.ATTENTION_SHAPES])
def test_attention_errors_interpret(shape):
    (res,) = cs.attention_errors(shapes=(shape,), batch=2, interpret=True)
    assert res["max_abs_err"] <= cs.ATTENTION_ABS


@pytest.mark.parametrize("numerics", sorted(cs.PARITY))
def test_data_parallel_parity_on_virtual_devices(numerics):
    res = cs.data_parallel_parity(4, steps=2, batch=8, model_overrides={
        "n_layers": 1, "d_model": 32, "n_head": 4, "ffn_hidden": 64,
        "numerics": numerics})
    assert len(res["losses_n"]) == 2
    assert res["loss_rel"] <= cs.PARITY[numerics]["loss_rel"]
    assert res["update_rel"] <= cs.PARITY[numerics]["update_rel"]


def test_check_records_failure_past_bound(capsys):
    checks = cs.Checks("test card, 1 W")
    checks.check("unit", "ok", 0.5, 1.0)
    checks.check("unit", "ok_high", 0.995, 0.99, higher_is_better=True)
    assert checks.failed == []
    checks.check("unit", "bad", 2.0, 1.0)
    assert len(checks.failed) == 1 and "unit/bad" in checks.failed[0]
    out = capsys.readouterr().out
    assert "result=pass" in out and "result=FAIL" in out and "card:" in out
