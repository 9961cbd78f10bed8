"""CSV -> batch-dict pipeline with a hash-bucket train/test split — the
port's copy of tf_yarn_tpu/data/csv.py.

numpy end to end, so the same file yields the same arrays bit for bit
in both packages; the split hash is crc32 (stable across processes).
"""

from __future__ import annotations

import csv
import zlib
from typing import Dict, Iterator, List, Optional

import numpy as np


def load_csv(
    path: str,
    label_column: str,
    feature_columns: Optional[List[str]] = None,
    delimiter: str = ";",
) -> Dict[str, np.ndarray]:
    """Read a numeric CSV into {"x": [N, F] float32, "y": [N] int32}."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh, delimiter=delimiter))
    if not rows:
        raise ValueError(f"no rows in {path}")
    feature_columns = feature_columns or [
        c for c in rows[0].keys() if c != label_column
    ]
    x = np.asarray(
        [[float(row[c]) for c in feature_columns] for row in rows], np.float32
    )
    y = np.asarray([int(float(row[label_column])) for row in rows], np.int32)
    return {"x": x, "y": y}


def train_test_split(
    data: Dict[str, np.ndarray], test_fraction: float = 0.2, buckets: int = 100
) -> "tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]":
    """Deterministic per-row hash split: row i is test iff
    crc32(str(i)) % buckets falls below test_fraction * buckets."""
    n = len(data["y"])
    hashes = np.asarray(
        [zlib.crc32(str(i).encode()) % buckets for i in range(n)]
    )
    test_mask = hashes < int(test_fraction * buckets)
    train = {k: v[~test_mask] for k, v in data.items()}
    test = {k: v[test_mask] for k, v in data.items()}
    return train, test


def batch_iterator(
    data: Dict[str, np.ndarray],
    batch_size: int,
    shuffle: bool = True,
    repeat: bool = True,
    seed: int = 0,
    rank: int = 0,
    world_size: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-shape batches (the tail dropped), rows sharded
    ``rank::world_size``, shuffled each epoch by one ``RandomState(seed)``."""
    n = len(data["y"])
    indices = np.arange(n)[rank::world_size]
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(indices) if shuffle else indices
        for start in range(0, len(order) - batch_size + 1, batch_size):
            take = order[start : start + batch_size]
            yield {k: v[take] for k, v in data.items()}
        if not repeat:
            return
