"""PR-AUC with the semantics of ``tf.keras.metrics.AUC``.

Counterpart of ``strajnet_tpu/objective/pr_auc.py``:
``AUC(num_thresholds=100, curve='PR', summation_method='interpolation')`` as a
pure function.

- Keras thresholds for ``num_thresholds=T``:
  ``[-eps, 1/(T-1), ..., (T-2)/(T-1), 1+eps]`` with eps=1e-7; a sample counts
  as predicted-positive at threshold t iff ``pred > t``.
- Counting: ``torch.bucketize(pred, thresholds)`` gives the number of
  thresholds strictly below each prediction, the positives and negatives of
  each bucket are counted with ``bincount`` (int64, exact; a histogram that
  data-parallel ranks can sum), and a reversed cumulative sum turns bucket
  counts into per-threshold counts. O(N) memory,
  no ``[N, T]`` comparison matrix. One pass counts every waypoint of a
  ``[B, T, ...]`` grid at once (``group_dim``).
- The value uses Keras' ``interpolate_pr_auc`` (Davis & Goadrich 2006).
"""

from __future__ import annotations

import torch

_KEPSILON = 1e-7


def _keras_thresholds(num_thresholds: int, device=None) -> torch.Tensor:
    inner = [(i + 1) * 1.0 / (num_thresholds - 1)
             for i in range(num_thresholds - 2)]
    return torch.tensor([-_KEPSILON] + inner + [1.0 + _KEPSILON],
                        dtype=torch.float32, device=device)


def bucket_histogram(y_true: torch.Tensor, y_pred: torch.Tensor,
                     num_thresholds: int = 100, group_dim=None
                     ) -> torch.Tensor:
    """The counts behind Keras' AUC: ``[G, 2, num_thresholds + 1]`` int64,
    per group the negatives (row 0) and positives (row 1) whose prediction
    lies above exactly ``j`` thresholds, for every ``j``.

    Args:
      y_true: any shape; Keras casts labels to bool, so any nonzero value
        counts as one full positive.
      y_pred: same shape, values in [0, 1].
      group_dim: None for one group of all elements, or a dimension of the
        inputs (the waypoint axis) whose every index is a group of its own,
        all counted in one pass over the data.

    Histograms of disjoint parts of the data add up to the histogram of
    the whole (the data-parallel ranks sum theirs).
    """
    thresholds = _keras_thresholds(num_thresholds, y_pred.device)
    if group_dim is None:
        groups = 1
        pos = y_true.reshape(1, -1) != 0
        pred = y_pred.reshape(1, -1)
    else:
        groups = y_pred.shape[group_dim]
        pos = y_true.movedim(group_dim, 0).reshape(groups, -1) != 0
        pred = y_pred.movedim(group_dim, 0).reshape(groups, -1)
    # bucket = number of thresholds t with t < pred, so pred > thresholds[j]
    # exactly for j < bucket
    bucket = torch.bucketize(pred.float().contiguous(), thresholds)
    n_buckets = num_thresholds + 1
    slot = (torch.arange(groups, device=pred.device)[:, None] * 2
            + pos.long()) * n_buckets + bucket
    hist = torch.bincount(slot.reshape(-1), minlength=groups * 2 * n_buckets)
    return hist.reshape(groups, 2, n_buckets)


def counts_from_histogram(hist: torch.Tensor):
    """Per-threshold (tp, fp, tn, fn), float32 ``[G, num_thresholds]``, of
    a :func:`bucket_histogram`."""
    # samples with bucket > j, for every threshold j
    above = hist.flip(-1).cumsum(-1).flip(-1)[..., 1:].float()
    fp, tp = above[:, 0], above[:, 1]
    totals = hist.sum(-1).float()
    total_neg, total_pos = totals[:, 0:1], totals[:, 1:2]
    return tp, fp, total_neg - fp, total_pos - tp


def confusion_counts(y_true: torch.Tensor, y_pred: torch.Tensor,
                     num_thresholds: int = 100, group_dim=None):
    """Per-threshold (tp, fp, tn, fn) with Keras AUC semantics: four
    float32 tensors, ``[num_thresholds]``, or ``[G, num_thresholds]`` with
    ``group_dim`` (see :func:`bucket_histogram`)."""
    counts = counts_from_histogram(bucket_histogram(
        y_true, y_pred, num_thresholds, group_dim))
    return counts if group_dim is not None else tuple(t[0] for t in counts)


def _interpolate_pr_auc(tp, fp, fn, num_thresholds: int) -> torch.Tensor:
    """Keras ``AUC.interpolate_pr_auc`` (Davis & Goadrich interpolation),
    over the last dimension."""
    zero = torch.zeros((), dtype=tp.dtype, device=tp.device)
    p = tp + fp
    p0, p1 = p[..., : num_thresholds - 1], p[..., 1:]
    dtp = tp[..., : num_thresholds - 1] - tp[..., 1:]
    dp = torch.clamp(p0 - p1, min=0)
    prec_slope = torch.where(dp > 0, dtp / torch.where(dp > 0, dp, 1.0), zero)
    intercept = tp[..., 1:] - prec_slope * p1

    # log(p0/p1) as log1p(dp/p1): equal in exact arithmetic to Keras'
    # log(safe_p_ratio), far more accurate in f32 when p0 ~ p1
    safe = (p0 > 0) & (p1 > 0)
    log_ratio = torch.where(
        safe, torch.log1p((p0 - p1) / torch.where(p1 > 0, p1, 1.0)), zero)

    denom = torch.clamp(tp[..., 1:] + fn[..., 1:], min=0)
    num = prec_slope * (dtp + intercept * log_ratio)
    increment = torch.where(denom > 0,
                            num / torch.where(denom > 0, denom, 1.0), zero)
    return increment.sum(-1)


def pr_auc(y_true: torch.Tensor, y_pred: torch.Tensor,
           num_thresholds: int = 100, group_dim=None) -> torch.Tensor:
    """PR-AUC matching Keras AUC(curve='PR', summation='interpolation'): a
    scalar, or one value per index of ``group_dim``."""
    tp, fp, _, fn = confusion_counts(y_true, y_pred, num_thresholds,
                                     group_dim)
    return _interpolate_pr_auc(tp, fp, fn, num_thresholds)


def pr_auc_from_histogram(hist: torch.Tensor) -> torch.Tensor:
    """PR-AUC per group ``[G]`` of a :func:`bucket_histogram` (or of the
    sum of several)."""
    tp, fp, _, fn = counts_from_histogram(hist)
    return _interpolate_pr_auc(tp, fp, fn, hist.shape[-1] - 1)


def pr_auc_from_counts(tp, fp, fn, num_thresholds: int = 100) -> torch.Tensor:
    """PR-AUC from accumulated confusion counts (for streaming evaluation)."""
    return _interpolate_pr_auc(tp, fp, fn, num_thresholds)
