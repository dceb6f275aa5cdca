"""Evaluation / training plots (matplotlib artifacts matching the reference's:
confusion-matrix heatmaps, accuracy-vs-SNR line plot, 2-panel training history
— ref: ViT/training/utils.py:177-281, 408-443).

matplotlib is optional: `plotting_available()` says whether it is installed,
and callers skip the figures when it is not. It is imported only here, inside
the functions, so the train/evaluate path never needs it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def plotting_available() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")  # headless
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(
    cm: np.ndarray,
    class_names: Sequence[str],
    accuracy: float,
    title: str = "Confusion Matrix",
    save_path: Optional[Path] = None,
    normalize: bool = True,
    figsize: Tuple[int, int] = (14, 12),
) -> None:
    """Annotated heatmap of a [K, K] count matrix (rows = true label), like
    the reference's (ref: ViT/training/utils.py:216-281)."""
    plt = _pyplot()
    display = cm.astype(np.float64)
    if normalize:
        row_sums = display.sum(axis=1, keepdims=True)
        # rows with no samples stay 0 (np.divide leaves unwritten entries
        # uninitialized without `out`)
        display = np.divide(display, np.maximum(row_sums, 1),
                            out=np.zeros_like(display), where=row_sums > 0)

    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(display, cmap="Blues")
    fig.colorbar(im, ax=ax, label="Proportion" if normalize else "Count")
    ticks = np.arange(len(class_names))
    ax.set_xticks(ticks, labels=class_names, rotation=90)
    ax.set_yticks(ticks, labels=class_names)
    if len(class_names) <= 24:
        fmt = "{:.2f}" if normalize else "{:.0f}"
        threshold = display.max() / 2 if display.size else 0
        for i in range(display.shape[0]):
            for j in range(display.shape[1]):
                ax.text(j, i, fmt.format(display[i, j]), ha="center",
                        va="center", fontsize=7,
                        color="white" if display[i, j] > threshold else "black")
    ax.set_xlabel("Predicted Label")
    ax.set_ylabel("True Label")
    ax.set_title(f"{title}\nAccuracy: {accuracy * 100:.2f}%")
    fig.tight_layout()
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def plot_accuracy_vs_snr(
    snr_accuracy_pairs: List[Tuple[float, float]],
    overall_accuracy: float,
    target_snrs: Sequence[int],
    prefix: str,
    save_path: Path,
) -> None:
    """Line plot of accuracy over every unique SNR with overall reference line
    (ref: ViT/training/utils.py:408-443). Accuracies in percent."""
    plt = _pyplot()
    snrs, accs = zip(*snr_accuracy_pairs)
    fig = plt.figure(figsize=(12, 6))
    plt.plot(snrs, accs, "b-o", linewidth=2, markersize=6)
    plt.axhline(y=overall_accuracy * 100, color="r", linestyle="--", linewidth=2,
                label=f"Overall: {overall_accuracy * 100:.2f}%")
    for t in target_snrs:
        plt.axvline(x=t, color="gray", linestyle=":", alpha=0.5)
    plt.xlabel("SNR (dB)", fontsize=12)
    plt.ylabel("Accuracy (%)", fontsize=12)
    plt.title(f"Accuracy vs SNR - {prefix.capitalize()} Set", fontsize=14, fontweight="bold")
    plt.grid(True, alpha=0.3)
    plt.legend(fontsize=11)
    plt.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def plot_training_history(history: Dict[str, list], save_path: Path) -> None:
    """2-panel loss/accuracy curves (ref: ViT/training/utils.py:177-213)."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(15, 5))
    epochs = np.arange(1, len(history["train_loss"]) + 1)
    ax1.plot(epochs, history["train_loss"], "b-", label="Train Loss")
    ax1.plot(epochs, history["val_loss"], "r-", label="Validation Loss")
    ax1.set_xlabel("Epoch"); ax1.set_ylabel("Loss")
    ax1.set_title("Training and Validation Loss")
    ax1.legend(); ax1.grid(True, alpha=0.3)
    ax2.plot(epochs, np.asarray(history["train_acc"]) * 100, "b-", label="Train Accuracy")
    ax2.plot(epochs, np.asarray(history["val_acc"]) * 100, "r-", label="Validation Accuracy")
    ax2.set_xlabel("Epoch"); ax2.set_ylabel("Accuracy (%)")
    ax2.set_title("Training and Validation Accuracy")
    ax2.legend(); ax2.grid(True, alpha=0.3)
    fig.tight_layout()
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
