"""Segmentation metrics (port of ``pfst_tpu/core/evaluation/metrics.py``;
mirrors ``rsiseg/core/evaluation/metrics.py``).

Per-image (intersect, union, pred_area, label_area) histograms, numpy on
the host, streamed into a running sum (the reference's ``pre_eval``
protocol, ``custom.py:644-683``), then turned into IoU/Dice/Fscore/acc
tables. Histograms are float64 counts: exact where the JAX file's float32
device histograms are (below 2^24 pixels a class), and beyond.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Union

import numpy as np


def intersect_and_union(pred_label,
                        label,
                        num_classes: int,
                        ignore_index: int,
                        label_map: Optional[dict] = None,
                        reduce_zero_label: bool = False):
    """Histograms for one (H, W) or a batch (B, H, W) of predictions
    (``metrics.py:26-87``): applies ``label_map`` / ``reduce_zero_label``
    to the label, drops ``ignore_index`` pixels from *both* maps, and
    returns four (num_classes,) float64 histograms."""
    pred_label = np.asarray(pred_label)
    label = np.asarray(label)
    if label_map:
        out = label.copy()
        for old_id, new_id in label_map.items():
            out[label == old_id] = new_id
        label = out
    if reduce_zero_label:
        label = np.where(label == 0, 255, label.astype(np.int64) - 1)
        label = np.where(label == 254, 255, label)
    valid = label != ignore_index
    lbl = label[valid].astype(np.int64)
    prd = pred_label[valid].astype(np.int64)

    def hist(x):
        return np.bincount(x, minlength=num_classes)[:num_classes] \
            .astype(np.float64)

    area_intersect = hist(prd[prd == lbl])
    area_pred = hist(prd[(prd >= 0) & (prd < num_classes)])
    area_label = hist(lbl[(lbl >= 0) & (lbl < num_classes)])
    area_union = area_pred + area_label - area_intersect
    return area_intersect, area_union, area_pred, area_label


def total_intersect_and_union(results, gt_seg_maps, num_classes,
                              ignore_index, label_map=None,
                              reduce_zero_label=False):
    """Accumulate over a corpus (``metrics.py:89``)."""
    total = [np.zeros((num_classes,), np.float64) for _ in range(4)]
    for res, gt in zip(results, gt_seg_maps):
        parts = intersect_and_union(res, gt, num_classes, ignore_index,
                                    label_map, reduce_zero_label)
        for t, p in zip(total, parts):
            t += p
    return tuple(total)


def f_score(precision, recall, beta=1):
    return (1 + beta**2) * (precision * recall) / (
        (beta**2 * precision) + recall)


def total_area_to_metrics(total_area_intersect,
                          total_area_union,
                          total_area_pred_label,
                          total_area_label,
                          metrics: Union[str, Sequence[str]] = ('mIoU',),
                          nan_to_num: Optional[int] = None,
                          beta: int = 1) -> Dict[str, np.ndarray]:
    """Histograms -> metric table (``metrics.py:300-395``)."""
    if isinstance(metrics, str):
        metrics = [metrics]
    allowed = ['mIoU', 'mDice', 'mFscore']
    if not set(metrics).issubset(set(allowed)):
        raise KeyError(f'metrics {metrics} is not supported')

    total_area_intersect = np.asarray(total_area_intersect, np.float64)
    total_area_union = np.asarray(total_area_union, np.float64)
    total_area_pred_label = np.asarray(total_area_pred_label, np.float64)
    total_area_label = np.asarray(total_area_label, np.float64)

    with np.errstate(divide='ignore', invalid='ignore'):
        all_acc = total_area_intersect.sum() / total_area_label.sum()
        ret: Dict[str, np.ndarray] = OrderedDict({'aAcc': all_acc})
        for metric in metrics:
            if metric == 'mIoU':
                ret['IoU'] = total_area_intersect / total_area_union
                ret['Acc'] = total_area_intersect / total_area_label
            elif metric == 'mDice':
                ret['Dice'] = 2 * total_area_intersect / (
                    total_area_pred_label + total_area_label)
                ret['Acc'] = total_area_intersect / total_area_label
            elif metric == 'mFscore':
                precision = total_area_intersect / total_area_pred_label
                recall = total_area_intersect / total_area_label
                ret['Fscore'] = np.array([
                    f_score(p, r, beta) for p, r in zip(precision, recall)
                ])
                ret['Precision'] = precision
                ret['Recall'] = recall
    if nan_to_num is not None:
        ret = OrderedDict({
            m: np.nan_to_num(v, nan=nan_to_num) for m, v in ret.items()
        })
    return ret


def pre_eval_to_metrics(pre_eval_results,
                        metrics=('mIoU',),
                        nan_to_num=None,
                        beta=1):
    """List of per-image 4-tuples -> metrics (``metrics.py:256``)."""
    pre_eval_results = tuple(zip(*pre_eval_results))
    assert len(pre_eval_results) == 4
    sums = [np.sum(np.stack([np.asarray(x, np.float64) for x in r]), axis=0)
            for r in pre_eval_results]
    return total_area_to_metrics(*sums, metrics=metrics,
                                 nan_to_num=nan_to_num, beta=beta)


def eval_metrics(results,
                 gt_seg_maps,
                 num_classes,
                 ignore_index,
                 metrics=('mIoU',),
                 nan_to_num=None,
                 label_map=None,
                 reduce_zero_label=False,
                 beta=1):
    """Corpus evaluation from label maps (``metrics.py:300``)."""
    totals = total_intersect_and_union(results, gt_seg_maps, num_classes,
                                       ignore_index, label_map,
                                       reduce_zero_label)
    return total_area_to_metrics(*totals, metrics=metrics,
                                 nan_to_num=nan_to_num, beta=beta)
