"""Train/test splitting of interaction matrices.

Mirrors the reference ``train_test_split`` (R/utils.R:11-28): a per-element
Bernoulli split of each user's interactions into train/test triplet sets.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


def train_test_split(
    x: sp.spmatrix,
    test_proportion: float = 0.5,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """Split interactions into train/test matrices of the same shape."""
    if rng is None:
        rng = np.random.default_rng()
    coo = sp.coo_matrix(x)
    keep_train = rng.random(coo.nnz) >= test_proportion
    def build(mask):
        return sp.csr_matrix(
            (coo.data[mask], (coo.row[mask], coo.col[mask])), shape=coo.shape)
    train, test = build(keep_train), build(~keep_train)
    for m in (train, test):
        m.row_names = getattr(x, "row_names", None)  # type: ignore[attr-defined]
        m.col_names = getattr(x, "col_names", None)  # type: ignore[attr-defined]
    return train, test
