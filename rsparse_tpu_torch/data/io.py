"""Interaction-log ingestion: raw rating logs into CSR matrices.

Port of ``rsparse_tpu/data/io.py``.  The text parsing rides the native
OpenMP parser (``native/rsparse_host.cpp`` ``parse_interactions``) with a
numpy fallback; logs whose ids are not integers are tokenized on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..native import parse_interactions_bytes


def _parse_string_ids(buf: bytes, sep: str, skip_header: bool):
    """Tokenizer for logs whose user/item ids are not integers."""
    lines = buf.decode("utf-8", errors="replace").splitlines()
    if skip_header and lines:
        lines = lines[1:]
    users, items, ratings = [], [], []
    for ln in lines:
        parts = ln.split(sep)
        if len(parts) < 2:
            continue
        users.append(parts[0].strip())
        items.append(parts[1].strip())
        try:
            ratings.append(float(parts[2]) if len(parts) > 2 else 1.0)
        except ValueError:
            ratings.append(1.0)
    return (np.asarray(users), np.asarray(items),
            np.asarray(ratings, np.float32))


def load_interactions(
    path: str,
    sep: str = ",",
    skip_header: bool = True,
    remap_ids: bool = True,
) -> sp.csr_matrix:
    """Read ``user<sep>item[<sep>rating]`` lines into a CSR matrix (float64
    values, duplicates summed).

    With ``remap_ids`` (default) raw identifiers are densified into
    contiguous 0-based indices in sorted order, and the originals are
    attached as ``row_names`` / ``col_names`` (strings) so predictions map
    back (the dimnames flow of the reference,
    R/MatrixFactorizationRecommender.R:71-77).  ``remap_ids=False`` takes
    integer ids as the indices themselves and raises for string ids.  The
    matrix also carries ``parser``: "native", "numpy" or "strings"
    (the host tokenizer).
    """
    with open(path, "rb") as f:
        buf = f.read()
    users, items, ratings, parser = parse_interactions_bytes(
        buf, sep, skip_header)
    if len(users) == 0:
        # non-numeric identifiers: only meaningful densified, so an
        # explicit remap_ids=False is an error rather than a silent remap
        users, items, ratings = _parse_string_ids(buf, sep, skip_header)
        parser = "strings"
        if len(users) and not remap_ids:
            raise ValueError(
                f"{path} has non-numeric user/item ids, which require "
                "remap_ids=True")
    if len(users) == 0:
        raise ValueError(f"no interactions parsed from {path}")
    if remap_ids:
        u_ids, u_inv = np.unique(users, return_inverse=True)
        i_ids, i_inv = np.unique(items, return_inverse=True)
        m = sp.csr_matrix((ratings.astype(np.float64), (u_inv, i_inv)),
                          shape=(len(u_ids), len(i_ids)))
        m.row_names = [str(v) for v in u_ids]   # type: ignore[attr-defined]
        m.col_names = [str(v) for v in i_ids]   # type: ignore[attr-defined]
    else:
        m = sp.csr_matrix((ratings.astype(np.float64), (users, items)))
        m.row_names = None                       # type: ignore[attr-defined]
        m.col_names = None                       # type: ignore[attr-defined]
    m.sum_duplicates()
    m.parser = parser                            # type: ignore[attr-defined]
    return m
