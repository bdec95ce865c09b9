"""K9's row-map mode (a RankMF batch on a mesh rank), split out on the CPU.

A mesh rank runs K9 on compact tables holding only the rows a batch's bits
reach (``models/rankmf.py`` ``batch_rows``), reading feature row f at
compact row ``map[f]``.  Its plain version (``_rankmf_batch_plain`` with
``wmap`` / ``hmap``) is held here to the one-process plain version on the
same bits and tables: the compact rows to the full tables' rows at 1e-6
(they read 0), the counters exactly, and every row the one-process batch
changes lies in ``batch_rows``.  Both losses, both optimizers, identity and
side features, and a batch whose users repeat.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rsparse_tpu_torch.models import rankmf as port

TOL = 1e-6


def _interactions(seed, n_user, n_item=50, density=0.2):
    x = sp.random(n_user, n_item, density=density, format="csr",
                  random_state=np.random.RandomState(seed))
    x.data[:] = 1.0
    x.sort_indices()
    return x


def _side(seed, n, n_feat):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 2)
    cols = np.stack([rng.choice(n_feat, 2, replace=False)
                     for _ in range(n)]).reshape(-1)
    return sp.csr_matrix((rng.uniform(0.5, 1.5, 2 * n), (rows, cols)),
                         shape=(n, n_feat))


@pytest.mark.parametrize("features", ["identity", "side", "duplicates"])
@pytest.mark.parametrize("optimizer", [port.ADAGRAD, port.RMSPROP],
                         ids=["adagrad", "rmsprop"])
@pytest.mark.parametrize("loss", [port.BPR, port.WARP], ids=["bpr", "warp"])
def test_rowmap_plain_matches_one_process(loss, optimizer, features):
    n_user = 6 if features == "duplicates" else 80
    x = _interactions(3, n_user)
    n_item = x.shape[1]
    uf = itf = None
    if features == "side":
        uf = port._pad_features(_side(4, n_user, 20), torch.float64, "cpu")
        itf = port._pad_features(_side(5, n_item, 15), torch.float64, "cpu")
    nuf = n_user if uf is None else 20
    nif = n_item if itf is None else 15
    rng = np.random.default_rng(7)
    r, S, K = 6, 48, 7
    tables = [torch.as_tensor(rng.standard_normal((nuf, r)) * 0.3),
              torch.as_tensor(rng.standard_normal((nif, r)) * 0.3),
              torch.as_tensor(rng.uniform(1, 2, nuf)),
              torch.as_tensor(rng.uniform(1, 2, nif))]
    pos = port._stage_positives(x, "cpu")
    hp = port.BatchParams(lr=0.3, gamma=0.9, lam_u=0.01, lam_ip=0.02,
                          lam_in=0.03, margin=0.05)
    cfg = port.BatchConfig(S, K, loss, port.IDENTITY, optimizer, True)
    bits = torch.as_tensor(rng.integers(0, 1 << 32, (S, K + 2)))
    full = [t.clone() for t in tables]
    c1 = port._rankmf_batch_plain(*full, bits, pos, uf, itf, hp, cfg, n_item)
    rows_w, rows_h = port.batch_rows(bits, pos, uf, itf, n_item)
    maps = []
    for rows, n in ((rows_w, nuf), (rows_h, nif)):
        m = torch.full((n,), -1, dtype=torch.int32)
        m[rows] = torch.arange(rows.shape[0], dtype=torch.int32)
        maps.append(m)
    ids = (rows_w, rows_h, rows_w, rows_h)
    comp = [t[i].clone() for t, i in zip(tables, ids)]
    c2 = port._rankmf_batch_plain(*comp, bits, pos, uf, itf, hp, cfg, n_item,
                                  wmap=maps[0], hmap=maps[1])
    assert c1.tolist() == c2.tolist()
    assert int(c1[2]) > 0
    for name, f, c, t, i in zip(("W", "H", "accW", "accH"), full, comp,
                                tables, ids):
        np.testing.assert_allclose(c.numpy(), f[i].numpy(), rtol=0, atol=TOL,
                                   err_msg=name)
        changed = (f != t).reshape(t.shape[0], -1).any(1)
        inside = torch.zeros(t.shape[0], dtype=torch.bool)
        inside[i] = True
        assert not (changed & ~inside).any(), f"{name}: a row outside the map"
