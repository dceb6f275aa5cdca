"""Model evaluation: batched jit inference, overall + per-SNR confusion
matrices, classification-report text (the cross-tool API), accuracy-vs-SNR
plot, pickled raw results.

Artifact-for-artifact parity with the reference's
`evaluate_model_with_confusion` (ref: ViT/training/utils.py:284-466):

  {prefix}_confusion_matrix_overall.png
  {prefix}_confusion_matrix_snr_{t}dB.png   for t in (-8, 0, 8) within ±0.5 dB
  {prefix}_classification_report.txt
  {prefix}_accuracy_vs_snr.png
  {prefix}_results.pkl                       (ref: ViT/training/evaluate.py:211-214)

The inference loop differs: one jitted forward over padded fixed-shape
batches (preprocessing fused in), predictions accumulated on host.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import jax
import numpy as np

from vitiq.eval import plots
from vitiq.eval.report import confusion_matrix, write_classification_report

TARGET_SNRS = (-8, 0, 8)  # ref: ViT/training/utils.py:349


def predict_all(
    forward_fn: Callable,
    params,
    x: np.ndarray,
    batch_size: int,
    preprocess_fn: Optional[Callable] = None,
    mesh=None,
) -> np.ndarray:
    """Batched argmax predictions for every row of x (final batch padded).

    With `mesh` (a jax.sharding.Mesh), serving runs multi-chip: each batch is
    placed as a global array sharded over the mesh's data axis and parameters
    are placed per the TP rules, so jit's partitioner scales inference across
    devices exactly like the sharded train step (the reference has no distributed
    serving at all — SURVEY.md §2.9)."""
    step, params, sharding = _make_predict_step(
        forward_fn, params, preprocess_fn, mesh, batch_size)

    n = len(x)
    preds = np.empty(n, dtype=np.int64)
    for start in range(0, n, batch_size):
        bx = x[start:start + batch_size]
        n_valid = len(bx)
        if n_valid < batch_size:
            bx = np.concatenate([bx, np.zeros((batch_size - n_valid,) + bx.shape[1:], bx.dtype)])
        if sharding is not None:
            bx = jax.device_put(bx, sharding)
        preds[start:start + n_valid] = np.asarray(step(params, bx))[:n_valid]
    return preds


def _make_predict_step(forward_fn, params, preprocess_fn, mesh, batch_size):
    """Shared jitted argmax step + (sharding, params) placement for a mesh."""
    if mesh is not None:
        from vitiq.parallel.mesh import batch_sharding, shard_params

        sharding = batch_sharding(mesh)
        params = shard_params(params, mesh)
        if batch_size % np.prod([mesh.shape[a] for a in mesh.axis_names if "data" in a]):
            raise ValueError(
                f"batch_size {batch_size} must divide evenly over the mesh's "
                f"data axes {dict(mesh.shape)}")
    else:
        sharding = None

    @jax.jit
    def step(params, bx):
        inputs = preprocess_fn(bx) if preprocess_fn is not None else bx
        return forward_fn(params, inputs, train=False).argmax(axis=-1)

    return step, params, sharding


def predict_feed(
    forward_fn: Callable,
    params,
    feed,
    batch_size: int,
    preprocess_fn: Optional[Callable] = None,
    mesh=None,
    prefetch_depth: int = 3,
):
    """Streaming predictions over a DataFeed's raw (x, y, snr) batches.

    Returns (preds, labels, snrs) numpy arrays — the whole split never has
    to be resident; only `prefetch_depth + 1` batches are live at once."""
    from vitiq.data.pipeline import Prefetcher

    step, params, sharding = _make_predict_step(
        forward_fn, params, preprocess_fn, mesh, batch_size)

    def padded():
        for bx, by, bz in feed.raw_batches(batch_size):
            n_valid = len(bx)
            if n_valid < batch_size:
                bx = np.concatenate(
                    [bx, np.zeros((batch_size - n_valid,) + bx.shape[1:], bx.dtype)])
            dev_bx = jax.device_put(bx, sharding) if sharding is not None else bx
            yield dev_bx, by, bz, n_valid

    preds_parts, label_parts, snr_parts = [], [], []
    for bx, by, bz, n_valid in Prefetcher(padded(), prefetch_depth=prefetch_depth):
        preds_parts.append(np.asarray(step(params, bx))[:n_valid])
        label_parts.append(np.asarray(by))
        snr_parts.append(np.asarray(bz))
    return (np.concatenate(preds_parts), np.concatenate(label_parts),
            np.concatenate(snr_parts))


def evaluate_model_with_confusion(
    forward_fn: Callable,
    params,
    x: np.ndarray,
    labels: np.ndarray,
    snrs: np.ndarray,
    class_names: Sequence[str],
    save_dir: str | Path,
    prefix: str = "test",
    batch_size: int = 256,
    preprocess_fn: Optional[Callable] = None,
    save_pickle: bool = True,
    make_plots: bool = True,
    verbose: bool = True,
    mesh=None,
) -> Dict:
    """Full evaluation; returns the reference's result dict
    (overall_accuracy, snr_accuracies, confusion_matrix, predictions, labels,
    snrs — ref: ViT/training/utils.py:459-466)."""
    labels = np.asarray(labels)
    snrs = np.asarray(snrs)
    preds = predict_all(forward_fn, params, x, batch_size, preprocess_fn, mesh=mesh)
    return confusion_artifacts(preds, labels, snrs, class_names, save_dir,
                               prefix=prefix, save_pickle=save_pickle,
                               make_plots=make_plots, verbose=verbose)


def evaluate_feed_with_confusion(
    forward_fn: Callable,
    params,
    feed,
    class_names: Sequence[str],
    save_dir: str | Path,
    prefix: str = "test",
    batch_size: int = 256,
    preprocess_fn: Optional[Callable] = None,
    save_pickle: bool = True,
    make_plots: bool = True,
    verbose: bool = True,
    mesh=None,
) -> Dict:
    """evaluate_model_with_confusion over a DataFeed — the streaming twin
    used by out-of-core runs (cfg.data.streaming): predictions accumulate
    batch-by-batch, the frames themselves are never all resident."""
    preds, labels, snrs = predict_feed(forward_fn, params, feed, batch_size,
                                       preprocess_fn, mesh=mesh)
    return confusion_artifacts(preds, labels, snrs, class_names, save_dir,
                               prefix=prefix, save_pickle=save_pickle,
                               make_plots=make_plots, verbose=verbose)


def confusion_artifacts(
    preds: np.ndarray,
    labels: np.ndarray,
    snrs: np.ndarray,
    class_names: Sequence[str],
    save_dir: str | Path,
    prefix: str = "test",
    save_pickle: bool = True,
    make_plots: bool = True,
    verbose: bool = True,
) -> Dict:
    """Steps 1-4 of the reference's evaluate_model_with_confusion given
    predictions: CMs, report txt, acc-vs-SNR plot, pickle
    (ref: ViT/training/utils.py:284-466). Figures need matplotlib; without
    it they are skipped with one printed line."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    if make_plots and not plots.plotting_available():
        print("matplotlib is not installed: evaluation figures skipped")
        make_plots = False
    K = len(class_names)

    # 1. overall confusion matrix
    cm_overall = confusion_matrix(labels, preds, K)
    acc_overall = float((labels == preds).mean()) if len(labels) else 0.0
    if make_plots:
        plots.plot_confusion_matrix(
            cm_overall, class_names, acc_overall,
            title=f"Overall Confusion Matrix - {prefix.capitalize()} Set",
            save_path=save_dir / f"{prefix}_confusion_matrix_overall.png",
        )
    if verbose:
        print(f"Overall Accuracy: {acc_overall * 100:.2f}%")

    # 2. per-SNR confusion matrices at the target SNRs (±0.5 dB mask,
    #    ref: utils.py:349-377)
    snr_accuracies: Dict[int, float] = {}
    for target in TARGET_SNRS:
        mask = np.abs(snrs - target) <= 0.5
        if mask.sum() == 0:
            if verbose:
                print(f"no samples found for SNR = {target} dB")
            continue
        acc = float((labels[mask] == preds[mask]).mean())
        if make_plots:
            plots.plot_confusion_matrix(
                confusion_matrix(labels[mask], preds[mask], K), class_names, acc,
                title=f"Confusion Matrix - {prefix.capitalize()} Set (SNR = {target} dB)",
                save_path=save_dir / f"{prefix}_confusion_matrix_snr_{target}dB.png",
            )
        snr_accuracies[target] = acc
        if verbose:
            print(f"Accuracy @ {target} dB: {acc * 100:.2f}%  ({int(mask.sum()):,} samples)")

    # 3. classification report text — the format compare tooling parses
    write_classification_report(
        save_dir / f"{prefix}_classification_report.txt",
        prefix, acc_overall, snr_accuracies, labels, preds, list(class_names),
    )

    # 4. accuracy vs SNR over every unique SNR (ref: utils.py:408-443)
    snr_acc_pairs: List = []
    for snr in sorted(np.unique(snrs)):
        m = snrs == snr
        if m.sum() > 0:
            snr_acc_pairs.append((float(snr), float((preds[m] == labels[m]).mean() * 100)))
    if make_plots and snr_acc_pairs:
        plots.plot_accuracy_vs_snr(snr_acc_pairs, acc_overall, TARGET_SNRS, prefix,
                             save_dir / f"{prefix}_accuracy_vs_snr.png")

    results = {
        "overall_accuracy": acc_overall,
        "snr_accuracies": snr_accuracies,
        "confusion_matrix": cm_overall,
        "predictions": preds,
        "labels": labels,
        "snrs": snrs,
        "accuracy_vs_snr": snr_acc_pairs,
    }
    if save_pickle:
        with open(save_dir / f"{prefix}_results.pkl", "wb") as f:
            pickle.dump(results, f)
    return results
