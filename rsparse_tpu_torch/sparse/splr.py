"""Sparse-plus-low-rank lazy matrix: ``x + a @ b.T``.

A copy of ``rsparse_tpu/sparse/splr.py`` (numpy only).  Reference
R/splr.R:6-114 (borrowed from softImpute; most methods are commented out /
nocov there).  Provides the operations the SoftALS/
LinearFlow stack needs without ever materializing the dense sum.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class SparsePlusLowRank:
    """Lazy ``x + a @ b.T`` with matmul/crossprod/rowsum support."""

    def __init__(self, x: sp.spmatrix, a: np.ndarray, b: np.ndarray):
        x = sp.csr_matrix(x)
        a = np.asarray(a)
        b = np.asarray(b)
        if a.shape[0] != x.shape[0] or b.shape[0] != x.shape[1]:
            raise ValueError("a must be (n_rows, r), b (n_cols, r)")
        if a.shape[1] != b.shape[1]:
            raise ValueError("a and b must share the low-rank dimension")
        self.x = x
        self.a = a
        self.b = b

    @property
    def shape(self):
        return self.x.shape

    def __matmul__(self, other: np.ndarray) -> np.ndarray:
        other = np.asarray(other)
        return self.x @ other + self.a @ (self.b.T @ other)

    def rmatmul(self, other: np.ndarray) -> np.ndarray:
        """other @ (x + a b')"""
        other = np.asarray(other)
        return other @ self.x + (other @ self.a) @ self.b.T

    def crossprod(self, other: np.ndarray = None) -> np.ndarray:
        """(x + a b')' @ other  (reference R/splr.R crossprod methods)."""
        if other is None:
            dense = self.toarray()
            return dense.T @ dense
        other = np.asarray(other)
        return self.x.T @ other + self.b @ (self.a.T @ other)

    def row_sums(self) -> np.ndarray:
        return (np.asarray(self.x.sum(axis=1)).ravel()
                + self.a @ self.b.sum(axis=0))

    def col_sums(self) -> np.ndarray:
        return (np.asarray(self.x.sum(axis=0)).ravel()
                + self.b @ self.a.sum(axis=0))

    @property
    def T(self) -> "SparsePlusLowRank":
        return SparsePlusLowRank(self.x.T.tocsr(), self.b, self.a)

    def toarray(self) -> np.ndarray:
        return self.x.toarray() + self.a @ self.b.T
