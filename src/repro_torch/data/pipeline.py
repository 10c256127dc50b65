"""Deterministic, resumable data pipeline, the counterpart of
``repro/data/pipeline.py``: a batch is a pure function of (seed, step), so
a resumed run recomputes it from the restored step counter.

  * :class:`SyntheticTokens` — counter-based Philox batches, bit for bit
    the reference's for each (seed, step);
  * :class:`FileTokens` — a memory-mapped int32 token file read in
    deterministic strided windows.

Both expose ``get_batch(step)`` → ``{"tokens": (B, S + 1) int32}`` as numpy
arrays; :func:`place_batch` moves a batch to a device.  The reference's
context synthesizer for the vlm and audio families comes with them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig


def _philox(seed: int, step: int, shape) -> np.ndarray:
    """Counter-based deterministic stream (numpy Philox), the reference's
    ``_philox``."""
    return np.random.Generator(
        np.random.Philox(key=seed, counter=step)).integers(
        0, 2 ** 31 - 1, size=shape, dtype=np.int64)


@dataclasses.dataclass
class SyntheticTokens:
    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = _philox(self.seed, step,
                       (self.batch, self.seq + 1)) % self.cfg.vocab
        return {"tokens": toks.astype(np.int32)}


@dataclasses.dataclass
class FileTokens:
    """Binary token file (int32 little-endian), strided deterministic
    reads."""
    cfg: ArchConfig
    path: str
    batch: int
    seq: int
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self._n_windows = max(1, (len(self._data) - 1) // (self.seq + 1))

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        idx = _philox(self.seed, step, (self.batch,)) % self._n_windows
        rows = np.stack([
            self._data[i * (self.seq + 1):(i + 1) * (self.seq + 1)]
            for i in np.asarray(idx)])
        return {"tokens": (rows % self.cfg.vocab).astype(np.int32)}


def make_pipeline(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                  path: Optional[str] = None):
    if path:
        return FileTokens(cfg, path, shape.global_batch, shape.seq_len,
                          seed)
    return SyntheticTokens(cfg, shape.global_batch, shape.seq_len, seed)


def place_batch(batch: Dict[str, np.ndarray], device
                ) -> Dict[str, torch.Tensor]:
    """Host → device: every array (or tensor) of the batch as a tensor on
    ``device`` (the reference's ``place_batch`` puts them under its mesh
    shardings)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
