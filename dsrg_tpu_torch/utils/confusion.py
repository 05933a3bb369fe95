"""Segmentation evaluation: confusion matrix, mIoU, recall, accuracy
(``dsrg_tpu/utils/confusion.py``, after the reference's
``training/tools/evaluate.py:17-68``).

* Pixels with ``gt >= nclass`` (VOC's 255 boundary) or a prediction outside
  ``[0, nclass)`` are ignored;
* ``jaccard()`` averages IoU only over classes whose diagonal entry is
  non-zero (``evaluate.py:52-59``), the reference's quirk, kept, and returns
  ``(mean_iou, per_class_list, matrix)``;
* ``recall`` / ``accuracy`` are the column / row diagonal ratios averaged
  over all classes.

:func:`confusion_matrix_torch` is the on-device matrix (the JAX package's
``confusion_matrix_jax``): one ``torch.bincount`` where the masks are.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def confusion_matrix_np(gt: np.ndarray, pred: np.ndarray, nclass: int) -> np.ndarray:
    """Vectorized (nclass, nclass) confusion matrix; gt >= nclass is ignored."""
    gt = np.asarray(gt).ravel().astype(np.int64)
    pred = np.asarray(pred).ravel().astype(np.int64)
    # out-of-range predictions (e.g. the 255 "unseeded" marker in cue masks)
    # are ignored along with out-of-range ground truth
    valid = (gt < nclass) & (pred < nclass)
    idx = gt[valid] * nclass + pred[valid]
    return np.bincount(idx, minlength=nclass * nclass).reshape(nclass, nclass).astype(np.float64)


def confusion_matrix_torch(gt: torch.Tensor, pred: torch.Tensor, nclass: int) -> torch.Tensor:
    """(nclass, nclass) float32 confusion matrix on ``gt``'s device; pixels
    whose gt or prediction lies outside ``[0, nclass)`` land in a discard
    bin.  Sum the matrices of several batches for a whole set."""
    gt = gt.reshape(-1).to(torch.int64)
    pred = pred.reshape(-1).to(torch.int64)
    valid = (gt >= 0) & (gt < nclass) & (pred >= 0) & (pred < nclass)
    idx = torch.where(valid, gt * nclass + pred, torch.full_like(gt, nclass * nclass))
    counts = torch.bincount(idx, minlength=nclass * nclass + 1)
    return counts[:-1].reshape(nclass, nclass).to(torch.float32)


class ConfusionMatrix:
    """Mirror of the reference's ConfusionMatrix (evaluate.py:17-68)."""

    def __init__(self, nclass: int, classes: Optional[List[str]] = None):
        self.nclass = nclass
        self.classes = classes
        self.M = np.zeros((nclass, nclass), dtype=np.float64)

    def add(self, gt, pred) -> None:
        self.M += confusion_matrix_np(gt, pred, self.nclass)

    def addM(self, matrix) -> None:
        matrix = np.asarray(matrix.cpu() if isinstance(matrix, torch.Tensor) else matrix, np.float64)
        if matrix.shape != self.M.shape:
            raise ValueError(f"confusion matrix of shape {matrix.shape}, expected {self.M.shape}")
        self.M += matrix

    def generateM(self, item) -> np.ndarray:
        gt, pred = item
        return confusion_matrix_np(gt, pred, self.nclass)

    def recall(self) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.diag(self.M) / self.M.sum(axis=0)
        return float(np.sum(r) / self.nclass)

    def accuracy(self) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            a = np.diag(self.M) / self.M.sum(axis=1)
        return float(np.sum(a) / self.nclass)

    def jaccard(self) -> Tuple[float, List[float], np.ndarray]:
        jaccard_perclass = []
        for i in range(self.nclass):
            if self.M[i, i] != 0:
                denom = self.M[i, :].sum() + self.M[:, i].sum() - self.M[i, i]
                jaccard_perclass.append(float(self.M[i, i] / denom))
        mean = float(np.sum(jaccard_perclass) / len(jaccard_perclass))
        return mean, jaccard_perclass, self.M
