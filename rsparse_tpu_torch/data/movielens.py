"""Bundled MovieLens-100k.

The port ships its own copy of the rating matrix
(``rsparse_tpu_torch/data/movielens100k.RData``, the same file as the
reference's) and reads it with its own RData parser.
"""

from __future__ import annotations

import os

import scipy.sparse as sp

from .rdata import parse_rdata, s4_to_scipy

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "movielens100k.RData")


def load_movielens100k(path: str | None = None) -> sp.csr_matrix:
    """Load the MovieLens-100k rating matrix (943 users x 1682 items,
    values 1..5) with user/item identifiers attached as ``row_names`` /
    ``col_names``."""
    path = path or DEFAULT_PATH
    if not os.path.exists(path):
        raise FileNotFoundError(f"movielens100k.RData not found at {path}")
    m = s4_to_scipy(parse_rdata(path)["movielens100k"])
    csr = sp.csr_matrix(m)
    csr.row_names = m.row_names    # type: ignore[attr-defined]
    csr.col_names = m.col_names    # type: ignore[attr-defined]
    return csr
