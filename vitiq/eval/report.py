"""Classification-report text format: writer and parser.

The report text file is the machine-readable API between the evaluation layer
and the comparison tool — `compare_models.py` regex-parses "Overall Accuracy",
"SNR +N dB" and the sklearn per-class table out of it (ref:
compare_models.py:33-60 consuming the format written by
ViT/training/utils.py:384-401). Both sides are implemented here so the format
can't drift; the per-class table is computed in numpy, byte-identical to
sklearn's `classification_report(..., digits=4, zero_division=0)`.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def confusion_matrix(labels, preds, num_classes: int) -> np.ndarray:
    """[K, K] int64 counts, rows = true label, cols = prediction (sklearn's
    orientation, over all K classes even when some are absent)."""
    labels = np.asarray(labels, np.int64)
    preds = np.asarray(preds, np.int64)
    flat = labels * num_classes + preds
    return np.bincount(flat, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def _divide(num, den):
    """num / den with 0 where den == 0 (sklearn's zero_division=0)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def classification_report_text(labels, preds, class_names: List[str],
                               digits: int = 4) -> str:
    """sklearn's classification_report text, for every configured class
    (labels=range(K), zero_division=0), computed in numpy."""
    cm = confusion_matrix(labels, preds, len(class_names))
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    precision = _divide(tp, predicted)
    recall = _divide(tp, support)
    f1 = _divide(2 * tp, support + predicted)
    if not tp.any():
        # sklearn counts in floats when nothing at all is right, and prints
        # the supports as such ("9.0")
        support = support.astype(np.float64)
    total = support.sum()

    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(n) for n in class_names), len("weighted avg"), digits)
    report = ("{:>{width}s} " + " {:>9}" * 4).format("", *headers, width=width)
    report += "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(class_names, precision, recall, f1, support):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    accuracy = float(_divide(tp.sum(), total))
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}"
               + " {:>9}\n").format("accuracy", "", "", accuracy, total,
                                     width=width, digits=digits)
    # np.average(m, weights=support) as sklearn computes it, so the last
    # printed digit rounds the same way
    weighted = ((lambda m: float(np.average(m, weights=support))) if total
                else (lambda m: float(np.mean(m))))
    for heading, avg in (("macro avg", lambda m: float(np.mean(m))),
                         ("weighted avg", weighted)):
        report += row_fmt.format(heading, avg(precision), avg(recall), avg(f1),
                                 total, width=width, digits=digits)
    return report


def write_classification_report(
    path: str | Path,
    prefix: str,
    overall_accuracy: float,
    snr_accuracies: Dict[int, float],
    labels: np.ndarray,
    preds: np.ndarray,
    class_names: List[str],
) -> Path:
    """Write the exact reference report format (utils.py:384-401):

        Classification Report - Test Set
        ================= (80 chars) =====

        Overall Accuracy: 62.02%

        Accuracy by SNR:
          SNR  -8 dB: 13.44%
          ...

        ================================

        <sklearn classification_report, digits=4>

    Accuracies are fractions in [0, 1]. The table covers ALL configured
    classes: the reference's sklearn call raises when a class is absent
    from a (small) split (utils.py:384-389 passes target_names only); the
    text is byte-identical to its whenever every class appears.
    """
    report = classification_report_text(labels, preds, class_names)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(f"Classification Report - {prefix.capitalize()} Set\n")
        f.write("=" * 80 + "\n\n")
        f.write(f"Overall Accuracy: {overall_accuracy * 100:.2f}%\n\n")
        f.write("Accuracy by SNR:\n")
        for snr, acc in snr_accuracies.items():
            f.write(f"  SNR {snr:+3d} dB: {acc * 100:.2f}%\n")
        f.write("\n" + "=" * 80 + "\n\n")
        f.write(report)
    return path


class ClassificationReportParser:
    """Regex parser for report text files (ref: compare_models.py:23-60).

    Exposes overall_accuracy / snr_accuracies in PERCENT (as the reference
    does) and per-class precision/recall/f1/support. The class-name regex is
    widened to also match hyphenated names like AM-SSB-WC (the reference's
    `\\w+` silently dropped them — SURVEY.md §2.6 notes the limitation).
    """

    def __init__(self, report_path: str | Path):
        self.report_path = Path(report_path)
        self.overall_accuracy: Optional[float] = None
        self.snr_accuracies: Dict[int, float] = {}
        self.class_metrics: Dict[str, Dict[str, float]] = {}
        self.parse_report()

    def parse_report(self) -> None:
        content = self.report_path.read_text()

        overall = re.search(r"Overall Accuracy:\s+([\d.]+)%", content)
        if overall:
            self.overall_accuracy = float(overall.group(1))

        for snr, acc in re.findall(r"SNR\s+([-+]\d+)\s+dB:\s+([\d.]+)%", content):
            self.snr_accuracies[int(snr)] = float(acc)

        class_pattern = r"^\s*([\w-]+)\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)\s+(\d+)\s*$"
        for line in content.split("\n"):
            match = re.match(class_pattern, line)
            if match:
                name, precision, recall, f1, support = match.groups()
                if name not in ("accuracy", "macro", "weighted"):
                    self.class_metrics[name] = {
                        "precision": float(precision),
                        "recall": float(recall),
                        "f1-score": float(f1),
                        "support": int(support),
                    }
