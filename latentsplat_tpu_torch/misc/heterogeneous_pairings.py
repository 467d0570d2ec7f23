"""Index tables for all ordered view pairs except self-pairs.

Counterpart of latentsplat_tpu/misc/heterogeneous_pairings.py (numpy tables).
"""

from __future__ import annotations

import numpy as np


def generate_heterogeneous_index(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(index_self, index_other), each (n, n-1); row v of index_other lists
    every view except v, in ascending order."""
    arange = np.arange(n)
    index_self = np.repeat(arange[:, None], n - 1, axis=1)
    index_other = np.repeat(arange[None, :], n, axis=0).copy()
    index_other += np.triu(np.ones((n, n), dtype=np.int64))
    return index_self, index_other[:, :-1]


def generate_heterogeneous_index_transpose(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Self-inverse index that transposes a (view, other_view) table."""
    arange = np.arange(n)
    ones = np.ones((n, n), dtype=np.int64)
    index_self = np.repeat(arange[None, :], n, axis=0) + np.triu(ones)
    index_other = np.repeat(arange[:, None], n, axis=1) - (1 - np.triu(ones))
    return index_self[:, :-1], index_other[:, :-1]
