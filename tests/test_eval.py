"""Evaluation subsystem tests: report format round-trip, cross-compatibility
with the reference's actual checked-in report artifacts, full evaluation run
on a tiny model, and the comparison harness."""

from pathlib import Path

import jax
import numpy as np
import pytest

from vitiq.eval import (
    ClassificationReportParser,
    ModelComparison,
    evaluate_model_with_confusion,
    write_classification_report,
)

REF_REPORTS = Path("/root/reference/Transformer_Thesis")
VIT_REF_REPORT = (REF_REPORTS / "ViT/result/checkpoints/production_v2/evaluation/"
                  "test_classification_report.txt")
RAWIQ_REF_REPORT = (REF_REPORTS / "transformer_rawIQ/result/checkpoints/"
                    "exp_L9_H8_F1024_W1e-3/evaluation/test_classification_report.txt")


class TestReportFormat:
    def test_write_parse_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        labels = rng.integers(0, 3, 300)
        preds = labels.copy()
        preds[:60] = (preds[:60] + 1) % 3  # 80% accuracy
        path = write_classification_report(
            tmp_path / "r.txt", "test", 0.80, {-8: 0.1344, 0: 0.5231, 8: 0.9672},
            labels, preds, ["BPSK", "QPSK", "16QAM"],
        )
        parser = ClassificationReportParser(path)
        assert parser.overall_accuracy == pytest.approx(80.0)
        assert parser.snr_accuracies == {-8: 13.44, 0: 52.31, 8: 96.72}
        assert set(parser.class_metrics) == {"BPSK", "QPSK", "16QAM"}
        for m in parser.class_metrics.values():
            assert 0 <= m["precision"] <= 1 and m["support"] > 0

    @pytest.mark.skipif(not VIT_REF_REPORT.exists(), reason="reference artifacts absent")
    def test_parses_reference_artifacts(self):
        """Our parser must read the REFERENCE's actual report files — the text
        format is the cross-tool API (SURVEY.md §2.6)."""
        p = ClassificationReportParser(VIT_REF_REPORT)
        assert p.overall_accuracy == pytest.approx(62.02)
        assert p.snr_accuracies[-8] == pytest.approx(13.44)
        assert p.snr_accuracies[0] == pytest.approx(52.31)
        assert p.snr_accuracies[8] == pytest.approx(96.72)
        assert len(p.class_metrics) == 19

    @pytest.mark.skipif(not VIT_REF_REPORT.exists(), reason="reference artifacts absent")
    def test_written_format_matches_reference_structure(self, tmp_path):
        """Line-level structural equality of the header block with the
        reference's artifact."""
        ref_lines = VIT_REF_REPORT.read_text().split("\n")
        labels = np.zeros(10, np.int64)
        path = write_classification_report(
            tmp_path / "r.txt", "test", 0.6202, {-8: 0.1344, 0: 0.5231, 8: 0.9672},
            labels, labels, ["OOK"],
        )
        got_lines = path.read_text().split("\n")
        # header block: title, ===, blank, overall, blank, "Accuracy by SNR:", 3 SNR lines
        assert got_lines[0] == ref_lines[0] == "Classification Report - Test Set"
        assert got_lines[1] == ref_lines[1] == "=" * 80
        assert got_lines[3] == ref_lines[3] == "Overall Accuracy: 62.02%"
        assert got_lines[5] == ref_lines[5] == "Accuracy by SNR:"
        assert got_lines[6] == ref_lines[6]  # "  SNR  -8 dB: 13.44%"
        assert got_lines[7] == ref_lines[7]
        assert got_lines[8] == ref_lines[8]


class TestEvaluateModel:
    def test_full_evaluation_artifacts(self, tmp_path):
        from vitiq.config import ModelConfig
        from vitiq.data import SyntheticAMCDataset
        from vitiq.dsp import preprocess_batch_rawiq
        from vitiq.models import init_amc_params, make_forward

        cfg = ModelConfig(arm="rawiq", num_classes=2, d_model=32, n_head=4,
                          n_layers=1, ffn_hidden=64, seq_length=128, segment_size=16)
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        fwd = make_forward(cfg)
        ds = SyntheticAMCDataset(classes=("BPSK", "QPSK"), frames_per_class=50,
                                 frame_len=128, snrs_db=(-8.0, 0.0, 8.0), seed=0)
        stats = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
        res = evaluate_model_with_confusion(
            fwd, params, ds.X, ds.Y, ds.Z, ["BPSK", "QPSK"], tmp_path,
            prefix="test", batch_size=32,
            preprocess_fn=lambda x: preprocess_batch_rawiq(x, stats), verbose=False,
        )
        for name in ("test_confusion_matrix_overall.png",
                     "test_confusion_matrix_snr_-8dB.png",
                     "test_confusion_matrix_snr_0dB.png",
                     "test_confusion_matrix_snr_8dB.png",
                     "test_classification_report.txt",
                     "test_accuracy_vs_snr.png",
                     "test_results.pkl"):
            assert (tmp_path / name).exists(), name
        assert res["confusion_matrix"].sum() == len(ds)
        assert set(res["snr_accuracies"]) == {-8, 0, 8}
        assert len(res["predictions"]) == len(ds)
        # report must parse back to the same numbers
        p = ClassificationReportParser(tmp_path / "test_classification_report.txt")
        assert p.overall_accuracy == pytest.approx(res["overall_accuracy"] * 100, abs=0.01)

    def test_padding_does_not_leak(self, tmp_path):
        """Odd sample count with large batch: every sample predicted once."""
        from vitiq.config import ModelConfig
        from vitiq.models import init_amc_params, make_forward
        from vitiq.eval.evaluate import predict_all

        cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=16, n_head=2,
                          n_layers=1, ffn_hidden=32, seq_length=64, segment_size=16)
        params = init_amc_params(jax.random.PRNGKey(0), cfg)
        fwd = make_forward(cfg)
        x = np.random.default_rng(0).standard_normal((37, 2, 64)).astype(np.float32)
        p1 = predict_all(fwd, params, x, batch_size=16)
        p2 = predict_all(fwd, params, x, batch_size=37)
        np.testing.assert_array_equal(p1, p2)


class TestComparison:
    @pytest.mark.skipif(not RAWIQ_REF_REPORT.exists(), reason="reference artifacts absent")
    def test_reproduces_reference_headline_delta(self, tmp_path):
        """Feeding the REFERENCE's own two best report files must reproduce its
        published head-to-head: rawIQ - ViT = +1.42% overall
        (ref: comparison_results/summary_comparison.csv:2-5)."""
        mc = ModelComparison(VIT_REF_REPORT, RAWIQ_REF_REPORT, output_dir=tmp_path)
        insights = mc.run_comparison(verbose=False)
        assert insights["overall_improvement"] == pytest.approx(1.42, abs=0.01)
        assert insights["snr_improvements"][-8] == pytest.approx(0.42, abs=0.01)
        assert insights["snr_improvements"][0] == pytest.approx(4.77, abs=0.01)
        assert insights["snr_improvements"][8] == pytest.approx(2.47, abs=0.01)
        for name in ("summary_comparison.csv", "detailed_comparison.csv",
                     "snr_comparison.png", "per_class_metrics.png",
                     "f1_difference_heatmap.png", "overall_comparison.png"):
            assert (tmp_path / name).exists(), name
        # biggest per-class swings from the reference README
        detailed = mc.create_detailed_comparison_table()
        best = detailed.sort_values("F1 Diff", ascending=False).iloc[0]
        assert best["Modulation"] == "64QAM"
        assert best["F1 Diff"] == pytest.approx(18.66, abs=0.05)

    def test_synthetic_reports_comparison(self, tmp_path):
        rng = np.random.default_rng(1)
        labels = rng.integers(0, 2, 200)
        good = labels.copy(); good[:20] = 1 - good[:20]
        bad = labels.copy(); bad[:60] = 1 - bad[:60]
        pa = write_classification_report(tmp_path / "a.txt", "test", 0.9,
                                         {-8: 0.5, 0: 0.9, 8: 0.99}, labels, good,
                                         ["BPSK", "QPSK"])
        pb = write_classification_report(tmp_path / "b.txt", "test", 0.7,
                                         {-8: 0.3, 0: 0.7, 8: 0.9}, labels, bad,
                                         ["BPSK", "QPSK"])
        mc = ModelComparison(pa, pb, output_dir=tmp_path / "out")
        insights = mc.run_comparison(verbose=False)
        assert insights["overall_improvement"] == pytest.approx(-20.0)


def test_predict_all_sharded_matches_single_device():
    """Multi-chip serving (VERDICT r1 item 5): predict_all over a (data x
    model) mesh must produce the same predictions as the single-device path."""
    import jax
    from vitiq.config import ModelConfig
    from vitiq.models import init_amc_params, make_forward
    from vitiq.eval.evaluate import predict_all
    from vitiq.parallel import make_mesh

    cfg = ModelConfig(arm="rawiq", num_classes=5, d_model=32, n_head=4,
                      n_layers=2, ffn_hidden=64, seq_length=64, segment_size=16)
    params = init_amc_params(jax.random.PRNGKey(0), cfg)
    fwd = make_forward(cfg)
    x = np.random.default_rng(3).standard_normal((37, 2, 64)).astype(np.float32)

    single = predict_all(fwd, params, x, batch_size=8)
    mesh = make_mesh(data=4, model=2)
    sharded = predict_all(fwd, params, x, batch_size=8, mesh=mesh)
    np.testing.assert_array_equal(sharded, single)


def test_predict_all_sharded_rejects_indivisible_batch():
    import jax
    import pytest as _pytest
    from vitiq.config import ModelConfig
    from vitiq.models import init_amc_params, make_forward
    from vitiq.eval.evaluate import predict_all
    from vitiq.parallel import make_mesh

    cfg = ModelConfig(arm="rawiq", num_classes=3, d_model=32, n_head=4,
                      n_layers=1, ffn_hidden=64, seq_length=64, segment_size=16)
    params = init_amc_params(jax.random.PRNGKey(0), cfg)
    mesh = make_mesh(data=8, model=1)
    with _pytest.raises(ValueError):
        predict_all(make_forward(cfg), params,
                    np.zeros((6, 2, 64), np.float32), batch_size=6, mesh=mesh)


def test_bench_fused_infer_sharded_runs():
    """run_benchmarks with data_parallel shards the bench batch over the
    mesh (VERDICT r1 item 5: serving scale-out on the bench path)."""
    from vitiq.bench import run_benchmarks

    r = run_benchmarks("fused_vit_infer", batch_size=64, steps=3,
                       data_parallel=8)
    assert r["value"] > 0 and r["batch_size"] == 64


def test_bench_n_head_reaches_all_arms():
    """The d_head lever is measurable on every arm (it matters most on the
    1025-token conv1d arm); n_head must reach the rawiq entries, not just
    head_variant."""
    from vitiq.bench import run_benchmarks

    r = run_benchmarks("conv1d_infer", batch_size=4, steps=1, n_head=2)
    assert r["metric"].endswith("rawiq_conv1d_h2") and r["value"] > 0
    r = run_benchmarks("rawiq64_infer", batch_size=4, steps=1, n_head=4)
    assert r["metric"].endswith("rawiq_seg64_h4") and r["value"] > 0


# --------------------------------------------------------------------------
# numpy report + confusion matrix, with sklearn as the golden
# --------------------------------------------------------------------------

_CLASSES = ["OOK", "4ASK", "8ASK", "BPSK", "QPSK", "8PSK", "16PSK", "32PSK",
            "16APSK", "32APSK", "64APSK", "128APSK", "16QAM", "32QAM",
            "64QAM", "128QAM", "256QAM", "AM-SSB-WC", "AM-DSB-SC", "FM",
            "GMSK", "OQPSK", "CPFSK", "GFSK"]


def _case(name):
    """(labels, preds, class_names) for one golden scenario."""
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    if name == "balanced19":
        y = np.repeat(np.arange(19), 20)
        p = np.where(rng.random(y.size) < 0.6, y, rng.integers(0, 19, y.size))
        return y, p, _CLASSES[:19]
    if name == "absent_true_class":      # class 2 never in the labels
        y = rng.integers(0, 5, 200)
        y[y == 2] = 0
        return y, rng.integers(0, 5, 200), _CLASSES[:5]
    if name == "never_predicted":        # zero division in precision
        y = rng.integers(0, 5, 200)
        p = y.copy()
        p[p == 3] = 1
        return y, p, _CLASSES[:5]
    if name == "all_correct":
        y = rng.integers(0, 11, 300)
        return y, y.copy(), _CLASSES[:11]
    if name == "all_wrong":
        y = rng.integers(0, 4, 50)
        return y, (y + 1) % 4, _CLASSES[:4]
    if name == "single_sample":
        return np.array([2]), np.array([1]), _CLASSES[:3]
    if name == "hyphenated_24":
        y = rng.integers(0, 24, 500)
        p = np.where(rng.random(500) < 0.3, y, rng.integers(0, 24, 500))
        return y, p, _CLASSES
    if name == "binary":
        y = rng.integers(0, 2, 64)
        return y, rng.integers(0, 2, 64), ["BPSK", "QPSK"]
    if name == "one_class_seen":         # only class 0 in labels and preds
        return np.zeros(10, int), np.zeros(10, int), _CLASSES[:6]
    raise KeyError(name)


_CASES = ["balanced19", "absent_true_class", "never_predicted", "all_correct",
          "all_wrong", "single_sample", "hyphenated_24", "binary",
          "one_class_seen"]


class TestNumpyReport:
    @pytest.mark.parametrize("digits", [2, 3, 4])
    @pytest.mark.parametrize("case", _CASES)
    def test_text_matches_sklearn(self, case, digits):
        import warnings

        from sklearn.metrics import classification_report

        from vitiq.eval.report import classification_report_text

        y, p, names = _case(case)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = classification_report(y, p, labels=np.arange(len(names)),
                                         target_names=names, digits=digits,
                                         zero_division=0)
        assert classification_report_text(y, p, names, digits=digits) == want

    @pytest.mark.parametrize("case", _CASES)
    def test_confusion_matrix_matches_sklearn(self, case):
        import warnings

        from sklearn.metrics import confusion_matrix as sk_cm

        from vitiq.eval.report import confusion_matrix

        y, p, names = _case(case)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = sk_cm(y, p, labels=np.arange(len(names)))
        got = confusion_matrix(y, p, len(names))
        assert got.shape == (len(names), len(names))
        np.testing.assert_array_equal(got, want)


def test_figures_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    from vitiq.eval import confusion_artifacts, plots

    monkeypatch.setattr(plots, "plotting_available", lambda: False)
    labels, preds = np.array([0, 1, 2, 1]), np.array([0, 1, 1, 1])
    res = confusion_artifacts(preds, labels, np.array([0, 0, 8, 8]),
                              ["A", "B", "C"], tmp_path, verbose=False)
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert not list(tmp_path.glob("*.png"))
    assert (tmp_path / "test_classification_report.txt").exists()
    np.testing.assert_array_equal(res["confusion_matrix"],
                                  [[1, 0, 0], [0, 2, 0], [0, 1, 0]])


_BLOCKED_IMPORTS = """
import importlib.abc, sys
BLOCKED = {"sklearn", "matplotlib", "seaborn", "pandas", "h5py", "torch",
           "orbax", "flatbuffers"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
"""


def test_main_path_imports_only_core_packages(tmp_path):
    """train -> evaluate -> export -> serve on the synthetic source needs
    nothing outside JAX, numpy, scipy, optax, chex and einops (matplotlib
    only for the optional figures): run it with the others made
    unimportable."""
    import subprocess
    import sys
    import textwrap

    repo = Path(__file__).resolve().parents[1]
    script = _BLOCKED_IMPORTS + textwrap.dedent(f"""
        import jax
        jax.config.update("jax_platforms", "cpu")
        from vitiq.cli import main
        tiny = ["--n_layers", "1", "--d_model", "16", "--n_head", "2",
                "--ffn_hidden", "32", "--batch_size", "16"]
        exp = "result/checkpoints/iso"
        assert main(["train", "--preset", "rawiq_synthetic19", "--numerics",
                     "tpu", "--frames_per_class", "4", "--num_epochs", "1",
                     "--experiment_name", "iso"] + tiny) == 0
        assert main(["evaluate", "--checkpoint", exp]) == 0
        assert main(["export", "--experiment_dir", exp, "--output", "art",
                     "--batch_sizes", "8"]) == 0
        import numpy as np
        from vitiq.serve import ServingArtifact
        logits = ServingArtifact.load("art").run(np.zeros((3, 1024, 2), np.float32))
        assert logits.shape == (3, 19)
        print("MAIN PATH OK")
    """)
    env = {**__import__("os").environ, "PYTHONPATH": str(repo),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MAIN PATH OK" in out.stdout
    assert "matplotlib is not installed" in out.stdout


def test_confusion_plot_with_empty_rows(tmp_path):
    """A class with no samples leaves an all-zero row: the normalized
    heatmap must stay finite (it feeds the colour scale and tick layout)."""
    from vitiq.eval import plots

    if not plots.plotting_available():
        pytest.skip("matplotlib is not installed")
    cm = np.array([[3, 1, 0], [0, 0, 0], [0, 2, 5]])
    out = tmp_path / "cm.png"
    plots.plot_confusion_matrix(cm, ["A", "B", "C"], 8 / 11, save_path=out)
    assert out.exists() and out.stat().st_size > 0
