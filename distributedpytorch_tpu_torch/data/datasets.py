"""Dataset container: load, normalize-stats scan, split, debug subset.

A copy of ``distributedpytorch_tpu/data/datasets.py`` (numpy only): the same seed gives the same
arrays, mean and std as the JAX package.

Mirrors the reference's MNIST class responsibilities (ref dataloader.py:47-135)
minus iteration (pipeline.py) and transforms (augment.py, on device):

  * mean/std computed from raw train pixels exactly as the reference does:
    ``data.float().mean()/255`` over all pixels (ref dataloader.py:92-96) —
    scalar stats applied to every channel;
  * 90/10 train/valid split (VALID_RATIO=0.9, ref dataloader.py:23,129-133)
    via a seed-deterministic permutation (the torch ``random_split`` drew
    from the globally-seeded generator; same role here, explicit seed);
  * valid split uses eval transforms (ref dataloader.py:134-135);
  * --debug truncates train to 200 samples (ref dataloader.py:139-144) —
    and actually works from the CLI flag (the reference's DEBUG rebind never
    reached spawned children, SURVEY §5 config wart).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict

import numpy as np

from . import io
from ..config import VALID_RATIO, DEBUG_SUBSET


@dataclass
class Split:
    images: np.ndarray   # uint8 (N,H,W) grayscale or (N,H,W,3) rgb
    labels: np.ndarray   # int32 (N,)

    def __len__(self) -> int:
        return self.labels.shape[0]


@dataclass
class Dataset:
    name: str
    splits: Dict[str, Split]
    mean: float
    std: float
    nb_classes: int = 10

    def class_weights(self) -> np.ndarray:
        """Inverse-frequency weights for weighted CE / focal loss:
        w_c = N / (num_classes * count_c)."""
        counts = np.bincount(self.splits["train"].labels,
                             minlength=self.nb_classes).astype(np.float64)
        counts = np.maximum(counts, 1.0)
        w = len(self.splits["train"]) / (self.nb_classes * counts)
        return w.astype(np.float32)

    @property
    def channels(self) -> int:
        img = self.splits["train"].images
        return 1 if img.ndim == 3 else img.shape[-1]


def load_dataset(name: str, data_path: str, seed: int,
                 debug: bool = False, log: bool = False,
                 synthetic_fallback: bool = False) -> Dataset:
    tr_x, tr_y, te_x, te_y = io.load_raw(name, data_path,
                                         synthetic_fallback)

    # Normalization stats from raw train pixels (ref dataloader.py:92-96).
    mean = float(tr_x.astype(np.float32).mean() / 255.0)
    std = float(tr_x.astype(np.float32).std() / 255.0)

    # 90/10 train/valid split, deterministic (ref dataloader.py:129-133).
    n = tr_y.shape[0]
    n_train = int(n * VALID_RATIO)
    perm = np.random.default_rng(seed).permutation(n)
    tr_idx, va_idx = perm[:n_train], perm[n_train:]

    if debug:
        # ref dataloader.py:139-144 truncates train to 200; the valid/test
        # truncations the reference left commented out are enabled here so
        # --debug is a true smoke mode (divergence documented in README).
        tr_idx = tr_idx[:DEBUG_SUBSET]
        va_idx = va_idx[:DEBUG_SUBSET]
        te_x, te_y = te_x[:DEBUG_SUBSET], te_y[:DEBUG_SUBSET]

    ds = Dataset(
        name=name,
        splits={
            "train": Split(tr_x[tr_idx], tr_y[tr_idx]),
            "valid": Split(tr_x[va_idx], tr_y[va_idx]),
            "test": Split(te_x, te_y),
        },
        mean=mean,
        std=std,
        nb_classes=int(max(tr_y.max(), te_y.max())) + 1,
    )
    if log:  # ref dataloader.py:69-72
        logging.info(f"Number of training examples: {len(ds.splits['train'])}")
        logging.info(f"Number of validation examples: {len(ds.splits['valid'])}")
        logging.info(f"Number of testing examples: {len(ds.splits['test'])}")
    return ds
