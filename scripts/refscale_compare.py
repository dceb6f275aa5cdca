#!/usr/bin/env python
"""Best-vs-best comparison at reference scale (VERDICT r4 item 2, last leg).

The reference publishes its flagship cross-arm comparison as
comparison_results/summary_comparison.csv (+1.42 rawIQ-ViT best-vs-best,
ref: comparison_results/README.md:37-46). This driver builds the same
artifact family from the two CONVERGED refscale runs (the reference's exact
published pair: ViT production_v2 vs rawIQ exp_L9_H8_F1024_W1e-3 geometry)
trained on the 2.1M-frame impaired stand-in corpus:

  result/refscale_vit/evaluation/test_classification_report.txt
  result/refscale_rawiq_best/evaluation/test_classification_report.txt
    -> result/refscale_comparison/ (CSVs + plot families + insights)
    -> result/refscale_head_to_head.json (summary, ordering verdict)

Usage: python scripts/refscale_compare.py
"""
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    from vitiq.eval import ModelComparison

    root = pathlib.Path("result")
    reports = {}
    for arm, d in (("vit", "refscale_vit"), ("rawiq", "refscale_rawiq_best")):
        rp = root / d / "evaluation" / "test_classification_report.txt"
        if not rp.exists():
            print(f"missing {rp} — train/evaluate the {arm} arm first "
                  f"(vitiq train --source hdf5 --streaming --experiment_name {d})")
            return 1
        reports[arm] = rp

    out_dir = root / "refscale_comparison"
    mc = ModelComparison(reports["vit"], reports["rawiq"],
                         output_dir=str(out_dir))
    insights = mc.run_comparison(verbose=True)

    summary = {}
    for arm, d in (("vit", "refscale_vit"), ("rawiq", "refscale_rawiq_best")):
        rep = json.loads((root / d / "report.json").read_text())
        summary[arm] = {
            "experiment_dir": str(root / d),
            "epochs": rep["epochs"],
            "stopped_early": rep["stopped_early"],
            "test_overall_accuracy": rep["test_overall_accuracy"],
            "test_snr_accuracies": rep["test_snr_accuracies"],
        }
    delta = (summary["rawiq"]["test_overall_accuracy"]
             - summary["vit"]["test_overall_accuracy"])
    snr_delta = {
        k: (summary["rawiq"]["test_snr_accuracies"][k]
            - summary["vit"]["test_snr_accuracies"][k])
        for k in summary["vit"]["test_snr_accuracies"]
        if k in summary["rawiq"]["test_snr_accuracies"]}
    head = {
        "vit": summary["vit"],
        "rawiq": summary["rawiq"],
        "delta_rawiq_minus_vit": delta,
        "per_snr_delta_rawiq_minus_vit": snr_delta,
        "reference_anchor": {
            "note": "RadioML 2018.01A (ref comparison_results/"
                    "summary_comparison.csv:2-5): ViT 62.02, rawIQ 63.44 -> "
                    "+1.42 rawIQ; per-SNR +0.42/-8, +4.77/0, +2.47/+8 dB",
            "delta_rawiq_minus_vit": 1.42},
        "ordering_reproduced": bool(delta > 0),
        "comparison_dir": str(out_dir),
        "insights": insights,
    }
    out = root / "refscale_head_to_head.json"
    out.write_text(json.dumps(head, indent=2, default=float))
    print(json.dumps({k: head[k] for k in
                      ("delta_rawiq_minus_vit", "per_snr_delta_rawiq_minus_vit",
                       "ordering_reproduced")}, indent=2, default=float))
    print(f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
