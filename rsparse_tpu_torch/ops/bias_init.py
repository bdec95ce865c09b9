"""Alternating closed-form bias initialisation for WRMF.

Port of ``rsparse_tpu/ops/bias_init.py`` (numpy only, so ported as it is):
the reference's 5-sweep bias initialisers (``initialize_biases_explicit``
inst/include/wrmf_utils.hpp:33-82, ``initialize_biases_implicit`` :85-167)
written as segment sums.  Their per-entity streaming updates are
incremental weighted means, which do not depend on order:

  running mean with prior (m0, w0) over (v_i, w_i)  ==
      (w0*m0 + sum w_i v_i) / (w0 + sum w_i)

Runs on the host in float64, once per fit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def initialize_biases(
    x: sp.spmatrix,
    lam: float,
    dynamic_lambda: bool,
    non_negative: bool,
    calculate_global_bias: bool,
    is_explicit: bool,
    n_iter: int = 5,
) -> Tuple[float, np.ndarray, np.ndarray, sp.csr_matrix]:
    """Returns (global_bias, user_bias, item_bias, possibly-centred matrix).

    For explicit feedback with a global bias the returned matrix has the
    global mean subtracted from its values (the reference centres the
    matrix in place, wrmf_utils.hpp:48-51).
    """
    csr = sp.csr_matrix(x, dtype=np.float64, copy=True)
    if is_explicit:
        return _explicit(csr, lam, dynamic_lambda, non_negative,
                         calculate_global_bias, n_iter)
    return _implicit(csr, lam, non_negative, calculate_global_bias, n_iter)


def _explicit(csr, lam, dynamic_lambda, non_negative, calc_global, n_iter):
    n_users, n_items = csr.shape
    g = 0.0
    if calc_global:
        g = float(csr.data.mean()) if csr.nnz else 0.0
        csr.data -= g

    coo = sp.coo_matrix(csr)
    rows, cols, vals = coo.row, coo.col, coo.data
    nnz_u = np.bincount(rows, minlength=n_users).astype(np.float64)
    nnz_i = np.bincount(cols, minlength=n_items).astype(np.float64)
    lam_u = lam * (nnz_u if dynamic_lambda else 1.0)
    lam_i = lam * (nnz_i if dynamic_lambda else 1.0)

    user_bias = np.zeros(n_users)
    item_bias = np.zeros(n_items)
    for _ in range(n_iter):
        num = np.bincount(cols, weights=vals - user_bias[rows],
                          minlength=n_items)
        item_bias = num / (lam_i + np.maximum(nnz_i, 1e-300))
        item_bias[nnz_i == 0] = 0.0
        if non_negative:
            np.maximum(item_bias, 0.0, out=item_bias)
        num = np.bincount(rows, weights=vals - item_bias[cols],
                          minlength=n_users)
        user_bias = num / (lam_u + np.maximum(nnz_u, 1e-300))
        user_bias[nnz_u == 0] = 0.0
        if non_negative:
            np.maximum(user_bias, 0.0, out=user_bias)
    return g, user_bias, item_bias, csr


def _implicit(csr, lam, non_negative, calc_global, n_iter):
    n_users, n_items = csr.shape
    coo = sp.coo_matrix(csr)
    rows, cols, vals = coo.row, coo.col, coo.data

    g = 0.0
    if calc_global:
        s = float(vals.sum())
        g = s / (s + float(n_users) * float(n_items) - coo.nnz)
    if non_negative:
        g = max(0.0, g)

    nnz_u = np.bincount(rows, minlength=n_users).astype(np.float64)
    nnz_i = np.bincount(cols, minlength=n_items).astype(np.float64)
    sum_u = np.bincount(rows, weights=vals, minlength=n_users)
    sum_i = np.bincount(cols, weights=vals, minlength=n_items)

    # per-entity smoothed means and shrinkage factors (wrmf_utils.hpp:102-125)
    def means_adj(s, nnz, n_other):
        means = np.where(nnz > 0,
                         s / np.maximum(s + (n_other - nnz), 1e-300), 0.0)
        adj = np.where(nnz > 0, s + (n_other - nnz), float(n_other))
        adj = adj / (adj + lam)
        return means, adj

    user_means, user_adj = means_adj(sum_u, nnz_u, n_items)
    item_means, item_adj = means_adj(sum_i, nnz_i, n_users)

    w = vals - 1.0  # streaming weights (c - 1)
    wsum_i = np.bincount(cols, weights=w, minlength=n_items)
    wsum_u = np.bincount(rows, weights=w, minlength=n_users)

    user_bias = np.zeros(n_users)
    item_bias = np.zeros(n_items)
    for it in range(n_iter):
        bias_mean = user_bias.mean() if it > 0 else 0.0
        # weighted mean of the user biases each item sees, with prior
        # (bias_mean, weight n_users) — wrmf_utils.hpp:138-143
        num = np.bincount(cols, weights=w * user_bias[rows],
                          minlength=n_items)
        bias_this = (n_users * bias_mean + num) / (n_users + wsum_i)
        item_bias = (item_means - bias_this - g) * item_adj
        if non_negative:
            np.maximum(item_bias, 0.0, out=item_bias)

        bias_mean = item_bias.mean()
        num = np.bincount(rows, weights=w * item_bias[cols],
                          minlength=n_users)
        bias_this = (n_items * bias_mean + num) / (n_items + wsum_u)
        user_bias = (user_means - bias_this - g) * user_adj
        if non_negative:
            np.maximum(user_bias, 0.0, out=user_bias)
    return g, user_bias, item_bias, csr
