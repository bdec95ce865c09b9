"""k-means (internal helper, reference R/kmeans.R:2-25 over
src/kmeans.cpp:10-17's ``arma::kmeans`` wrapper).

Port of ``rsparse_tpu/models/kmeans.py``: Lloyd's algorithm as a torch
loop, the assignment step one dense distance matmul per iteration, in
float32.  Seed modes mirror arma's: ``static_subset`` / ``random_subset``
(centroids from data rows) and ``static_spread`` / ``random_spread``
(k-means++-style spread), drawn from ``np.random.default_rng`` as in the
reference, so the starting centroids are the reference's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _sq_dist(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    # squared distances via the expansion ||x||^2 - 2 x.c + ||c||^2
    return (torch.sum(x * x, 1, keepdim=True) - 2 * (x @ cent.T)
            + torch.sum(cent * cent, 1)[None, :])


def _lloyd(x: torch.Tensor, cent: torch.Tensor, n_iter: int):
    k = cent.shape[0]
    for _ in range(n_iter):
        assign = torch.argmin(_sq_dist(x, cent), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        counts = onehot.sum(0)
        sums = onehot.T @ x
        cent = torch.where(counts[:, None] > 0, sums / counts[:, None], cent)
    return cent, torch.argmin(_sq_dist(x, cent), dim=1)


def kmeans(
    x,
    k: int,
    n_iter: int = 10,
    seed_mode: str = "random_subset",
    seed: Optional[int] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster rows of ``x`` into ``k`` groups; returns (centroids,
    assignments) as numpy arrays."""
    xn = np.asarray(x, np.float32)
    n = xn.shape[0]
    if k > n:
        raise ValueError(f"k={k} > n_rows={n}")
    rng = np.random.default_rng(0 if "static" in seed_mode else seed)
    if seed_mode in ("static_subset", "random_subset"):
        chosen = rng.choice(n, size=k, replace=False)
    elif seed_mode in ("static_spread", "random_spread"):
        # k-means++-style: greedily pick far points
        chosen = [int(rng.integers(n))]
        d2 = np.sum((xn - xn[chosen[0]]) ** 2, axis=1)
        for _ in range(k - 1):
            p = d2 / max(d2.sum(), 1e-30)
            nxt = int(rng.choice(n, p=p))
            chosen.append(nxt)
            d2 = np.minimum(d2, np.sum((xn - xn[nxt]) ** 2, axis=1))
    else:
        raise ValueError(f"unknown seed_mode {seed_mode!r}")
    xt = torch.as_tensor(xn, device=device)
    cent, assign = _lloyd(xt, xt[torch.as_tensor(np.asarray(chosen),
                                                 device=device)], n_iter)
    return cent.cpu().numpy(), assign.cpu().numpy()
