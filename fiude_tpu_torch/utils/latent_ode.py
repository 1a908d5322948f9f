"""Latent-ODE evaluation utilities (Rubanova et al. tooling), numpy only.

The port's own copy of ``fiude_tpu/utils/latent_ode.py`` (the port imports
nothing of the JAX package), with the same ``__all__`` and the same draws:
every random choice goes through an explicit ``numpy.random.Generator``.

* mask/subsample tooling: ``subsample_timepoints``
  (``lib/Old/utils.py:116-151``) and ``cut_out_timepoints`` (``:155-174``),
  done functionally (fresh arrays) instead of in-place tensor mutation;
* batch-dict plumbing: ``split_and_subsample_batch`` (``:481-510``),
  ``split_data_extrap`` (``:378-406``), ``split_data_interp``
  (``:408-430``);
* loss-over-batches evaluation with binary AUC and one-hot accuracy:
  ``compute_loss_all_batches`` (``:514-611``), the ROC-AUC computed from the
  Mann-Whitney U statistic (average-rank ties).

Everything here is host-side bookkeeping around a model.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "subsample_timepoints",
    "cut_out_timepoints",
    "split_data_extrap",
    "split_data_interp",
    "split_and_subsample_batch",
    "roc_auc",
    "onehot_accuracy",
    "compute_loss_all_batches",
]


# ---------------------------------------------------------------------------
# Mask / subsample tooling
# ---------------------------------------------------------------------------

def subsample_timepoints(data, time_steps, mask, n_tp_to_sample=None,
                         rng: Optional[np.random.Generator] = None):
    """Keep only a random subset of observed time points per trajectory.

    Reference: ``lib/Old/utils.py:116-151``.  ``n_tp_to_sample > 1`` keeps
    exactly that many points (zeroing the rest); ``0 < n_tp_to_sample <= 1``
    keeps that *fraction* of each trajectory's observed (mask > 0) points.
    Returns fresh ``(data, time_steps, mask)`` arrays — the reference
    mutates its inputs in place.
    """
    if n_tp_to_sample is None:
        return data, time_steps, mask
    rng = rng or np.random.default_rng()
    data = np.array(data, copy=True)
    mask = None if mask is None else np.array(mask, copy=True)
    n_tp = len(time_steps)

    if n_tp_to_sample > 1:
        n_keep = int(n_tp_to_sample)
        if n_keep > n_tp:
            raise ValueError(
                f"n_tp_to_sample={n_keep} exceeds {n_tp} time points")
        for i in range(data.shape[0]):
            missing = np.sort(rng.choice(n_tp, n_tp - n_keep, replace=False))
            data[i, missing] = 0.0
            if mask is not None:
                mask[i, missing] = 0.0
    elif n_tp_to_sample > 0:
        if mask is None:
            raise ValueError("fractional subsampling requires a mask")
        for i in range(data.shape[0]):
            observed = np.where(mask[i].sum(-1) > 0)[0]
            n_keep = int(len(observed) * n_tp_to_sample)
            kept = np.sort(rng.choice(observed, n_keep, replace=False))
            dropped = np.setdiff1d(observed, kept)
            data[i, dropped] = 0.0
            mask[i, dropped] = 0.0
    return data, time_steps, mask


def cut_out_timepoints(data, time_steps, mask, n_points_to_cut=None,
                       rng: Optional[np.random.Generator] = None):
    """Zero a random *consecutive* block of time points per trajectory
    (reference ``lib/Old/utils.py:155-174``; start drawn from
    ``[5, n_tp - n_cut - 5)`` exactly as upstream)."""
    if n_points_to_cut is None:
        return data, time_steps, mask
    if n_points_to_cut < 1:
        raise ValueError("number of time points to cut out must be >= 1")
    rng = rng or np.random.default_rng()
    data = np.array(data, copy=True)
    mask = None if mask is None else np.array(mask, copy=True)
    n_tp = len(time_steps)
    n_cut = int(n_points_to_cut)
    if n_cut > n_tp:
        raise ValueError(f"n_points_to_cut={n_cut} exceeds {n_tp} points")

    for i in range(data.shape[0]):
        start = rng.integers(5, n_tp - n_cut - 5)
        data[i, start:start + n_cut] = 0.0
        if mask is not None:
            mask[i, start:start + n_cut] = 0.0
    return data, time_steps, mask


# ---------------------------------------------------------------------------
# Batch-dict plumbing
# ---------------------------------------------------------------------------

def _empty_batch_dict():
    """Skeleton batch dict (reference ``lib/Old/utils.py:378-391``)."""
    return {
        "observed_data": None, "observed_tp": None,
        "data_to_predict": None, "tp_to_predict": None,
        "observed_mask": None, "mask_predicted_data": None,
        "labels": None, "mode": None,
    }


def split_data_extrap(data_dict):
    """Condition on the first half of the time grid, predict the second
    (reference ``lib/Old/utils.py:378-406``)."""
    data = np.asarray(data_dict["data"])
    tp = np.asarray(data_dict["time_steps"])
    n_half = tp.shape[0] // 2
    out = _empty_batch_dict()
    out["observed_data"] = data[:, :n_half].copy()
    out["observed_tp"] = tp[:n_half].copy()
    out["data_to_predict"] = data[:, n_half:].copy()
    out["tp_to_predict"] = tp[n_half:].copy()
    mask = data_dict.get("mask")
    if mask is not None:
        mask = np.asarray(mask)
        out["observed_mask"] = mask[:, :n_half].copy()
        out["mask_predicted_data"] = mask[:, n_half:].copy()
    out["labels"] = data_dict.get("labels")
    out["mode"] = "extrap"
    return out


def split_data_interp(data_dict):
    """Autoencoding split: condition on and reconstruct the full grid
    (reference ``lib/Old/utils.py:408-430``)."""
    data = np.asarray(data_dict["data"])
    tp = np.asarray(data_dict["time_steps"])
    out = _empty_batch_dict()
    out["observed_data"] = data.copy()
    out["observed_tp"] = tp.copy()
    out["data_to_predict"] = data.copy()
    out["tp_to_predict"] = tp.copy()
    mask = data_dict.get("mask")
    if mask is not None:
        out["observed_mask"] = np.asarray(mask).copy()
        out["mask_predicted_data"] = np.asarray(mask).copy()
    out["labels"] = data_dict.get("labels")
    out["mode"] = "interp"
    return out


def split_and_subsample_batch(data_dict, *, extrap: bool = False,
                              sample_tp=None, cut_tp=None,
                              rng: Optional[np.random.Generator] = None):
    """Split a raw batch then optionally subsample/cut observed points
    (reference ``lib/Old/utils.py:481-510``)."""
    split = split_data_extrap(data_dict) if extrap \
        else split_data_interp(data_dict)
    if sample_tp is None and cut_tp is None:
        return split
    data, tp, mask = split["observed_data"], split["observed_tp"], \
        split["observed_mask"]
    if cut_tp is not None:
        data, tp, mask = cut_out_timepoints(data, tp, mask, cut_tp, rng=rng)
    if sample_tp is not None:
        data, tp, mask = subsample_timepoints(data, tp, mask, sample_tp,
                                              rng=rng)
    split["observed_data"], split["observed_tp"] = data, tp
    split["observed_mask"] = mask
    return split


# ---------------------------------------------------------------------------
# Classification metrics (numpy-only)
# ---------------------------------------------------------------------------

def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary ROC-AUC via the Mann-Whitney U statistic with average-rank
    tie handling (numerically identical to ``sklearn.metrics.roc_auc_score``
    for binary labels).  Replaces the reference's sklearn call at
    ``lib/Old/utils.py:592-593``."""
    labels = np.asarray(labels, dtype=np.float64).reshape(-1)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    pos = labels == 1.0
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes present")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(scores.size, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0  # average 1-based rank
        i = j + 1
    rank_sum_pos = ranks[pos].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def onehot_accuracy(labels: np.ndarray, predictions: np.ndarray) -> float:
    """Accuracy between one-hot labels and prediction logits, counting only
    labeled time points (reference ``lib/Old/utils.py:596-611``, the
    'activity' branch)."""
    labels = np.asarray(labels)
    predictions = np.asarray(predictions)
    labeled = labels.sum(-1) > 0
    if not labeled.any():
        raise ValueError("no labeled time points")
    pred_ids = predictions[labeled].argmax(-1).reshape(-1)
    true_ids = labels[labeled].argmax(-1).reshape(-1)
    return float((pred_ids == true_ids).mean())


# ---------------------------------------------------------------------------
# Loss-over-batches evaluation
# ---------------------------------------------------------------------------

_TOTAL_KEYS = ("loss", "likelihood", "mse", "kl_first_p", "std_first_p",
               "pois_likelihood", "ce_loss")


def compute_loss_all_batches(
    compute_losses: Callable[[Mapping], Dict[str, np.ndarray]],
    batches: Iterable[Mapping],
    *,
    classif: bool = False,
    classif_mode: str = "binary",
    total_keys: Sequence[str] = _TOTAL_KEYS,
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Average per-batch loss dicts over a test set, optionally appending
    classification metrics (reference ``lib/Old/utils.py:514-611``).

    ``compute_losses(batch_dict)`` is the model's loss function (the
    reference calls ``model.compute_all_losses``); when ``classif`` it must
    also return ``label_predictions`` shaped ``(n_traj_samples, ..., n_labels)``
    and the batch dict must carry ``labels``.  ``classif_mode`` is
    ``"binary"`` (ROC-AUC over non-NaN labels, physionet branch) or
    ``"onehot"`` (accuracy over labeled points, activity branch).
    """
    total = {k: 0.0 for k in total_keys}
    n_batches = 0
    all_preds, all_labels = [], []

    for batch in batches:
        if max_batches is not None and n_batches >= max_batches:
            break
        results = compute_losses(batch)
        for key in total:
            if key in results:
                total[key] += float(np.asarray(results[key]))
        if classif:
            preds = np.asarray(results["label_predictions"])
            n_labels = preds.shape[-1]
            n_traj = preds.shape[0]
            all_preds.append(preds.reshape(n_traj, -1, n_labels))
            all_labels.append(np.asarray(batch["labels"]).reshape(-1, n_labels))
        n_batches += 1

    if n_batches > 0:
        total = {k: v / n_batches for k, v in total.items()}

    if classif and all_preds:
        preds = np.concatenate(all_preds, axis=1)
        labels = np.concatenate(all_labels, axis=0)
        # each trajectory sample gets a copy of the labels (lib/Old/utils.py:580)
        labels = np.broadcast_to(labels, preds.shape).copy()
        if classif_mode == "binary":
            keep = ~np.isnan(labels)
            total["auc"] = 0.0
            if labels[keep].sum() != 0.0:
                total["auc"] = roc_auc(labels[keep], preds[keep])
        elif classif_mode == "onehot":
            total["accuracy"] = onehot_accuracy(labels, preds)
        else:
            raise ValueError(f"unknown classif_mode {classif_mode!r}")
    return total
