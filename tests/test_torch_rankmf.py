"""Port parity of RankMF (K9's plain version).

The same numpy-made interactions, side features and tables go through
``rsparse_tpu`` and ``rsparse_tpu_torch`` at float64 on the CPU, where the
port's wrapper runs K9's plain PyTorch version.  The reference samples with
``jax.random.bits``; the port takes the bits as an argument, so each batch
is held with the reference's own draw.  Stated tolerances: W, H and the
accumulators to 1e-10 absolute after each batch, the AUC and found/tried
counters exactly; the user hash tables bit for bit; carried-over models to
1e-10.  At model level the port samples with its own generator and is held
to the reference's ML-100k quality gate (AUC > 0.8, NDCG@10 > 0.15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu.models import rankmf as ref
from rsparse_tpu.parallel.sgd_sharded import DirectOps
from rsparse_tpu_torch.convert import rankmf_from_numpy
from rsparse_tpu_torch.models import rankmf as port

torch.set_num_threads(2)

TOL = 1e-10


def interactions(seed, n_user=40, n_item=30, density=0.25):
    x = sp.random(n_user, n_item, density=density, format="lil",
                  random_state=np.random.RandomState(seed))
    x[1, :] = 0                                   # a user without positives
    x = sp.csr_matrix(x)
    x.eliminate_zeros()
    x.data[:] = 1.0
    x.sort_indices()
    return x


def side_features(seed, n, n_feat, max_k=3):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        k = int(rng.integers(1, max_k + 1))
        rows += [i] * k
        cols += list(rng.choice(n_feat, size=k, replace=False))
        vals += list(rng.uniform(0.5, 1.5, k))
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n_feat))


@pytest.mark.parametrize("max_probe", [8, 2])
def test_build_user_hash_bit_identical(max_probe):
    x = interactions(0, n_user=300, n_item=500, density=0.05)
    for a, b in zip(port.build_user_hash(x, max_probe),
                    ref.build_user_hash(x, max_probe)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_build_user_hash_overflow_growth():
    """Adversarial collisions grow a user's bucket count
    (tests/test_fm_rankmf.py) and the port's probe answers exactly."""
    items = np.arange(0, 4096, 4, dtype=np.int32)
    x = sp.csr_matrix((np.ones(len(items)), items,
                       np.asarray([0, len(items)])), shape=(1, 4096))
    hp = port.build_user_hash(x, max_probe=2)
    for a, b in zip(hp, ref.build_user_hash(x, max_probe=2)):
        np.testing.assert_array_equal(a, np.asarray(b))
    q = torch.arange(4096)[None, :]
    got = port._in_hash_set(*(torch.from_numpy(a) for a in hp),
                            torch.zeros(1, dtype=torch.long), q)[0].numpy()
    want = np.zeros(4096, bool)
    want[items] = True
    np.testing.assert_array_equal(got, want)


def test_in_hash_set_matches_reference():
    x = interactions(1, n_user=300, n_item=500, density=0.05)
    hj = ref.build_user_hash(x, ref._MAX_PROBE)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 300, (64,)).astype(np.int32)
    q = rng.integers(0, 500, (64, 40)).astype(np.int32)
    want = np.asarray(ref._in_hash_set(*hj, jnp.asarray(u), jnp.asarray(q),
                                       ref._MAX_PROBE))
    got = port._in_hash_set(*(torch.from_numpy(np.array(a)) for a in hj),
                            torch.from_numpy(u).long(), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def _ref_inputs(x, uf, itf):
    uhash = ref.build_user_hash(x, ref._MAX_PROBE)
    return (jnp.asarray(x.indices, jnp.int32),
            jnp.asarray(x.indptr[:-1], jnp.int32),
            jnp.asarray(np.diff(x.indptr), jnp.int32), uhash,
            None if uf is None else ref._pad_features(uf, jnp.float64),
            None if itf is None else ref._pad_features(itf, jnp.float64))


FEATURES = ("identity", "side", "duplicates")


@pytest.mark.parametrize("features", FEATURES)
@pytest.mark.parametrize("optimizer", ["adagrad", "rmsprop"])
@pytest.mark.parametrize("kernel", ["identity", "sigmoid"])
@pytest.mark.parametrize("loss", ["bpr", "warp"])
def test_rankmf_batch_matches_reference(loss, kernel, optimizer, features):
    """Three batches in a row from the same tables with the reference's
    bits: W, H, accW, accH after each, and the counters."""
    dup = features == "duplicates"
    x = interactions(2, n_user=4 if dup else 40)
    n_user, n_item = x.shape
    uf = itf = None
    if features == "side":
        uf = side_features(3, n_user, 12)
        itf = side_features(4, n_item, 10)
    nuf = n_user if uf is None else uf.shape[1]
    nif = n_item if itf is None else itf.shape[1]
    S, K, r = 64, 6, 5
    lo = {"bpr": ref.BPR, "warp": ref.WARP}[loss]
    ke = {"identity": ref.IDENTITY, "sigmoid": ref.SIGMOID}[kernel]
    op = {"adagrad": ref.ADAGRAD, "rmsprop": ref.RMSPROP}[optimizer]
    hp = port.BatchParams(lr=0.3, gamma=0.9, lam_u=0.01, lam_ip=0.02,
                          lam_in=0.03, margin=0.05)
    rng = np.random.default_rng(5)
    init = [rng.standard_normal((nuf, r)) * 0.3,
            rng.standard_normal((nif, r)) * 0.3, rng.uniform(1, 2, nuf),
            rng.uniform(1, 2, nif)]
    tj = [jnp.asarray(a) for a in init]
    tt = [torch.tensor(a) for a in init]
    flat, indptr, row_nnz, uhash, ufj, itfj = _ref_inputs(x, uf, itf)
    pos = port._stage_positives(x, "cpu")
    uft = None if uf is None else port._pad_features(uf, torch.float64, "cpu")
    itft = None if itf is None else port._pad_features(itf, torch.float64,
                                                       "cpu")
    for step in range(3):
        update_items = step != 1
        cfg = (S, K, lo, ke, op, update_items)
        key = jax.random.PRNGKey(100 + step)
        *tj, an, ad, nf, nt = ref._rankmf_batch(
            DirectOps(), *tj, key, flat, indptr, row_nnz, uhash, ufj, itfj,
            *(jnp.asarray(v, jnp.float64) for v in hp), cfg, n_item,
            ref._MAX_PROBE)
        bits = np.asarray(jax.random.bits(key, (S, K + 2), jnp.uint32))
        c = port._rankmf_batch(*tt, torch.from_numpy(bits.astype(np.int64)),
                               pos, uft, itft, hp, port.BatchConfig(*cfg),
                               n_item)
        assert c.tolist() == [int(an), int(ad), int(nf), int(nt)]
        for name, a, b in zip(("W", "H", "accW", "accH"), tt, tj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL, err_msg=f"{name} {step}")
    assert int(nf) > 0
    assert all(np.isfinite(np.asarray(t)).all() for t in tt)


@pytest.fixture(scope="module")
def ml100k_fit():
    x = rt.load_movielens100k()
    train, test = rt.train_test_split(x, 0.2, np.random.default_rng(0))
    tr = sp.csr_matrix(train)
    m = rt.RankMF(rank=16, learning_rate=0.5, loss="bpr", seed=0,
                  batch_size=2048, device="cpu")
    emb = m.partial_fit_transform(tr, n_iter=200)
    return tr, test, m, emb


def test_rankmf_ml100k_quality_gate(ml100k_fit):
    """The reference's held-out gate (tests/test_fm_rankmf.py) with the
    port's own sampling: AUC > 0.8 and NDCG@10 > 0.15, through predict."""
    tr, test, m, emb = ml100k_fit
    assert emb.shape == (tr.shape[0], 16) and torch.isfinite(emb).all()
    assert m.auc_history[-1] > 0.8, m.auc_history
    preds = m.predict(tr, k=10, not_recommend=tr)
    ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
    assert ndcg > 0.15, ndcg


def test_rankmf_predict_through_base(ml100k_fit):
    """predict ranks transform(x) @ components with the training mask: its
    scores are the top-10 masked scores of each user."""
    tr, _, m, emb = ml100k_fit
    preds = m.predict(tr, k=10, not_recommend=tr)
    scores = emb.numpy().astype(np.float64) @ m.components
    scores[tr.nonzero()] = -np.inf
    top = -np.sort(-scores, axis=1)[:, :10]
    got = np.take_along_axis(scores, preds.indices.astype(np.int64), 1)
    np.testing.assert_allclose(got, top, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(preds.scores, top, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("side", [False, True])
def test_rankmf_from_numpy_carries_the_reference(side):
    x = interactions(6, n_user=60, n_item=50)
    uf = side_features(7, 60, 15) if side else None
    itf = side_features(8, 50, 12) if side else None
    kw = dict(rank=4, learning_rate=0.2, loss="warp", seed=0, batch_size=64,
              precision="double")
    mj = rt_ref.RankMF(**kw)
    ej = np.asarray(mj.partial_fit_transform(x, item_features=itf,
                                             user_features=uf, n_iter=5))
    mc = rankmf_from_numpy(np.asarray(mj.user_features_embeddings),
                           np.asarray(mj.item_features_embeddings),
                           np.asarray(mj._accW), np.asarray(mj._accH),
                           user_features=uf, item_features=itf, **kw,
                           device="cpu")
    et = mc.transform(x)
    et = et.numpy() if isinstance(et, torch.Tensor) else et
    np.testing.assert_allclose(et, ej, rtol=0, atol=TOL)
    np.testing.assert_allclose(mc.components, np.asarray(mj.components),
                               rtol=0, atol=TOL)
    if not side:
        np.testing.assert_array_equal(mc.predict(x, k=5).indices,
                                      mj.predict(x, k=5).indices)


def test_rankmf_side_features_and_rmsprop_duplicates():
    """Identical-feature items get identical components; RMSprop under heavy
    in-batch duplication keeps the accumulators finite and >= 0
    (tests/test_fm_rankmf.py)."""
    x = interactions(9, n_user=50, n_item=30, density=0.2)
    itf = sp.csr_matrix((np.ones(30), (np.arange(30), np.arange(30) % 10)),
                        shape=(30, 10))
    m = rt.RankMF(rank=4, learning_rate=0.05, seed=0, device="cpu")
    emb = m.partial_fit_transform(x, item_features=itf, n_iter=10)
    assert emb.shape == (50, 4)
    np.testing.assert_allclose(m.components[:, 0], m.components[:, 10],
                               rtol=1e-12)
    x4 = interactions(10, n_user=4, n_item=30, density=0.6)
    m = rt.RankMF(rank=4, learning_rate=0.1, optimizer="rmsprop", gamma=0.0,
                  seed=0, batch_size=512, device="cpu")
    emb = m.partial_fit_transform(x4, n_iter=30)
    assert torch.isfinite(emb).all() and (m._accW >= 0).all()
    assert np.isfinite(m.components).all()


def test_rankmf_errors_and_options():
    x = interactions(11)
    m = rt.RankMF(device="cpu")
    with pytest.raises(RuntimeError):
        m.transform(x)
    with pytest.raises(ValueError):
        m.partial_fit_transform(x, item_features=sp.identity(7, format="csr"))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        rt.RankMF(mesh=object(), device="cpu")
    assert rt.RankMF().device.type == "cuda"


def test_reference_quality():
    """``chip_smoke.REF_RANKMF_ML100K``, the AUC and NDCG@10 that
    chip_smoke.py phase 7 (b) prints beside the port's on the card, are the
    reference's (float32, its own random bits) for the fit of
    ``ml100k_fit``, scored in float64 with the training items masked."""
    import chip_smoke
    x = rt_ref.load_movielens100k()
    train, test = rt_ref.train_test_split(x, 0.2, np.random.default_rng(0))
    tr = sp.csr_matrix(train)
    m = rt_ref.RankMF(rank=16, learning_rate=0.5, loss="bpr", seed=0,
                      batch_size=2048)
    emb = m.partial_fit_transform(tr, n_iter=200)
    scores = np.asarray(emb, np.float64) @ np.asarray(m.components)
    scores[tr.nonzero()] = -np.inf
    top = np.argsort(-scores, axis=1)[:, :10]
    ndcg = float(np.nanmean(rt_ref.ndcg_k(top, test)))
    np.testing.assert_allclose((m.auc_history[-1], ndcg),
                               chip_smoke.REF_RANKMF_ML100K, rtol=0,
                               atol=5e-5)


# -- K9's windowed selection --------------------------------------------------

def _windowed(acceptable: torch.Tensor, window: int):
    """Launch A's selection replayed: the K candidates in windows (``window``
    of them, then up to 32 at a time), each one "any acceptable" ballot
    whose first set lane is taken.  Returns (first_k or 0, any found,
    windows run), each (S,)."""
    S, K = acceptable.shape
    first_k = torch.zeros((S,), dtype=torch.long)
    found = torch.zeros((S,), dtype=torch.bool)
    windows = torch.zeros((S,), dtype=torch.long)
    k0, w = 0, window
    while k0 < K:
        blk = acceptable[:, k0:k0 + w]
        live = ~found
        windows += live.long()
        hit = blk.any(1) & live
        first_k = torch.where(hit, k0 + blk.to(torch.uint8).argmax(1),
                              first_k)
        found |= hit
        k0, w = k0 + w, 32
    return first_k, found, windows


def _forced_streams(n_user=6, n_item=40, violators=(3, 10, 23, 36)):
    """Interactions and rank-2 tables that force the candidate streams:
    user u's positives are the items of its parity (user 1 has none, the
    last user has every item), every positive scores 1, a non-positive
    scores 1/2 (no WARP violator, an AUC hit) or, for the ``violators``, 1
    (a violator at margin 0.05).  Scores are sums of multiples of 1/4:
    exact in any order."""
    rows, cols = [], []
    for u in range(n_user):
        if u == 1:
            continue
        items = (range(n_item) if u == n_user - 1
                 else range(u % 2, n_item, 2))
        rows += [u] * len(items)
        cols += list(items)
    x = sp.csr_matrix((np.ones(len(rows)), (rows, cols)),
                      shape=(n_user, n_item))
    x.sort_indices()
    sign = np.where(np.arange(n_user) % 2 == 0, 1.0, -1.0)
    W = np.stack([np.ones(n_user), sign], 1)
    # r_uj = a_j + sign_u b_j: 1 for users of j's parity, else 1/2 or 1
    own = np.ones(n_item)
    other = np.where(np.isin(np.arange(n_item), violators), 1.0, 0.5)
    even = np.arange(n_item) % 2 == 0
    plus = np.where(even, own, other)      # a + b: what even users see
    minus = np.where(even, other, own)     # a - b: what odd users see
    H = np.stack([(plus + minus) / 2, (plus - minus) / 2], 1)
    return x, W, H


@pytest.mark.parametrize("loss", ["bpr", "warp"])
@pytest.mark.parametrize("window", [8, 16, 32])
def test_windowed_selection_matches_plain_and_reference(loss, window):
    """On forced candidate streams (positives first, no violator among the
    K, a violator at candidate 0, at the last candidate and in a later
    window), the windowed selection gives each sample the plain version's
    first candidate, found flag and count tried, and the AUC hit of
    candidate 0; its counters equal the plain version's and the JAX
    package's batch, whose tables the plain version matches (1e-10)."""
    x, W0, H0 = _forced_streams()
    n_user, n_item = x.shape
    S, K, r = 256, 20, 2
    lo = {"bpr": ref.BPR, "warp": ref.WARP}[loss]
    hp = port.BatchParams(lr=0.25, gamma=0.9, lam_u=0.0, lam_ip=0.0,
                          lam_in=0.0, margin=0.05)
    flat, indptr, row_nnz, uhash, _, _ = _ref_inputs(x, None, None)
    pos = port._stage_positives(x, "cpu")
    seen = {"positive first": 0, "none in K": 0, "at 0": 0, "at K - 1": 0,
            "later window": 0}
    for step in range(3):
        key = jax.random.PRNGKey(7 + step)
        cfg = (S, K, lo, ref.IDENTITY, ref.ADAGRAD, True)
        init = [W0, H0, np.ones(n_user), np.ones(n_item)]
        tj = [jnp.asarray(a) for a in init]
        tt = [torch.tensor(a) for a in init]
        *tj, an, ad, nf, nt = ref._rankmf_batch(
            DirectOps(), *tj, key, flat, indptr, row_nnz, uhash, None, None,
            *(jnp.asarray(v, jnp.float64) for v in hp), cfg, n_item,
            ref._MAX_PROBE)
        bits = torch.from_numpy(np.asarray(
            jax.random.bits(key, (S, K + 2), jnp.uint32)).astype(np.int64))
        c = port._rankmf_batch(*tt, bits, pos, None, None, hp,
                               port.BatchConfig(*cfg), n_item)
        assert c.tolist() == [int(an), int(ad), int(nf), int(nt)]
        for a, b in zip(tt, tj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)
        # the streams: membership and score of every candidate
        b = bits & 0xFFFFFFFF
        u = b[:, 0] % n_user
        valid = pos.row_nnz[u] > 0
        j = b[:, 2:] % n_item
        is_neg = ~port._in_hash_set(pos.table, pos.boff, pos.bmask,
                                    pos.bshift, u, j)
        Wt, Ht = torch.tensor(W0), torch.tensor(H0)
        i = pos.flat_idx[(pos.indptr[u].long() + b[:, 1]
                          % pos.row_nnz[u].clamp(min=1)).clamp(
                              0, pos.flat_idx.shape[0] - 1)].long()
        r_ui = (Wt[u] * Ht[i]).sum(1)
        d = torch.einsum("sr,skr->sk", Wt[u], Ht[j]) - r_ui[:, None]
        acceptable = is_neg if lo == ref.BPR else is_neg & (d + hp.margin
                                                            >= 0)
        first_k, any_ok, windows = _windowed(acceptable, window)
        found = any_ok & valid
        tried = torch.where(found, first_k + 1, K)
        auc_hit = valid & is_neg[:, 0] & (d[:, 0] < 0)
        pf, pk, pt = port._first_acceptable(acceptable, valid)
        assert torch.equal(found, pf) and torch.equal(tried, pt)
        assert torch.equal(first_k[found], pk[found])
        assert [int(auc_hit.sum()), int(valid.sum()), int(found.sum()),
                int(tried.sum())] == [int(an), int(ad), int(nf), int(nt)]
        # the walk ends with the window that holds the first acceptable
        last = torch.where(any_ok, first_k, K - 1)
        want = torch.where(last < window, 1,
                           2 + torch.clamp(last - window, min=0) // 32)
        assert torch.equal(windows, want)
        seen["positive first"] += int((found & ~is_neg[:, 0]).sum())
        seen["none in K"] += int((valid & ~found).sum())
        seen["at 0"] += int((found & (first_k == 0)).sum())
        seen["at K - 1"] += int((found & (first_k == K - 1)).sum())
        seen["later window"] += int((found & (first_k >= window)).sum())
    need = ["positive first", "none in K", "at 0"]
    if loss == "warp":
        need.append("at K - 1")
        if window < K:
            need.append("later window")
    assert all(seen[k] > 0 for k in need), seen
