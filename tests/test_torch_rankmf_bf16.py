"""RankMF at ``precision="bfloat16"`` (K9's bf16 plain version) against the
JAX package's bf16 RankMF on the CPU.

The same numpy-made interactions, side features and tables, cast to bf16
as both packages cast them (through float32), go through
``rsparse_tpu/models/rankmf.py:_rankmf_batch`` and the port's wrapper,
which runs K9's plain PyTorch version on CPU tensors, with the JAX
package's own ``jax.random.bits``.  Stated tolerances:

- one batch in every mode (BPR / WARP x identity / sigmoid x AdaGrad /
  RMSprop x identity / side / duplicate-heavy features) against the JAX
  function run op by op (``jax.disable_jit``): every cell of W, H, accW,
  accH equal, and the counters;
- the same batch against the JAX function jitted: the counters equal and
  at most ``JIT_SHARE`` of the cells apart (measured at most 23 of 132,
  17.4%, with side features; none in 12 of the 24 modes; bounded at twice
  that).  XLA's CPU compiler fuses the
  elementwise chains of the update (``grad / denom + lam * comb`` and
  ``-lr * step`` before the scatter-add) and skips their intermediate bf16
  roundings, so a jitted cell may sit a few spacings from the op-by-op
  value the port gives;
- 20 chained batches against the jitted JAX fit: the largest difference
  of any table from the JAX bf16 tables at most ``CHAIN_MAX`` (twice the
  measured) and below the JAX package's own distance between its bf16
  and float32 tables on the same bits;
- the stalling of rule 1 (a scatter-add of bf16 updates rounds once a
  duplicate): a hot row whose increments sit below half a spacing stays
  where the JAX package leaves it;
- ML-100k BPR rank 16: AUC within 0.01 of the JAX package's bf16 fit (the
  random bits differ) and the reference's gate, AUC > 0.8 and NDCG@10 >
  0.15, every table bf16; the JAX fit's (AUC, NDCG@10) is
  ``chip_smoke.REF_BF16["rankmf"]`` (held here to 1e-4), which the card's
  fit is held to.
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
from rsparse_tpu_torch.models import rankmf as port
from rsparse_tpu_torch.ops.segsum import ordered_add_

from test_torch_rankmf import interactions, side_features

torch.set_num_threads(2)

BF = jnp.bfloat16
#: share of a mode's cells (all four tables) a jitted JAX batch leaves
#: apart from the port's (twice the largest measured, 23 of 132)
JIT_SHARE = 0.35
#: 20 chained batches against the jitted JAX bf16 fit: the largest
#: difference of a table (twice the largest measured, 0.1797 with WARP,
#: sigmoid, RMSprop and side features, where the JAX package's own bf16
#: and float32 tables lie 0.975 apart)
CHAIN_MAX = 0.36
FEATURES = ("identity", "side", "duplicates")
OPS = DirectOps()
#: the JAX batch jitted once (its static arguments: ops, cfg, n_item, probe)
JAX_STEP = jax.jit(ref._rankmf_batch, static_argnums=(0, 18, 19, 20))
HP = port.BatchParams(lr=0.3, gamma=0.9, lam_u=0.01, lam_ip=0.02,
                      lam_in=0.03, margin=0.05)


def _problem(features, r=5, seed=5, scale=0.3):
    dup = features == "duplicates"
    x = interactions(2, n_user=4 if dup else 40)
    n_user, n_item = x.shape
    uf = itf = None
    if features == "side":
        uf = side_features(3, n_user, 12)
        itf = side_features(4, n_item, 10)
    nuf = n_user if uf is None else uf.shape[1]
    nif = n_item if itf is None else itf.shape[1]
    rng = np.random.default_rng(seed)
    init = [rng.standard_normal((nuf, r)) * scale,
            rng.standard_normal((nif, r)) * scale, rng.uniform(1, 2, nuf),
            rng.uniform(1, 2, nif)]
    jx = dict(uhash=ref.build_user_hash(x, ref._MAX_PROBE),
              flat=jnp.asarray(x.indices, jnp.int32),
              indptr=jnp.asarray(x.indptr[:-1], jnp.int32),
              row_nnz=jnp.asarray(np.diff(x.indptr), jnp.int32))
    pt = dict(pos=port._stage_positives(x, "cpu"),
              uf=None if uf is None else port._pad_features(
                  uf, torch.bfloat16, "cpu"),
              itf=None if itf is None else port._pad_features(
                  itf, torch.bfloat16, "cpu"))
    jf = (None if uf is None else ref._pad_features(uf, BF),
          None if itf is None else ref._pad_features(itf, BF))
    return x, init, jx, jf, pt


def _jax_batch(tabs, key, jx, jf, cfg, n_item, dtype, jit):
    args = (OPS, *tabs, key, jx["flat"], jx["indptr"],
            jx["row_nnz"], jx["uhash"], *jf,
            *(jnp.asarray(v, dtype) for v in HP), cfg, n_item,
            ref._MAX_PROBE)
    if jit:
        return JAX_STEP(*args)
    with jax.disable_jit():
        return ref._rankmf_batch(*args)


def _port_batch(tt, key, pt, cfg, n_item):
    S, K = cfg[0], cfg[1]
    bits = np.asarray(jax.random.bits(key, (S, K + 2), jnp.uint32))
    hp = port.BatchParams(*(port.bf16_value(v) for v in HP))
    return port._rankmf_batch(*tt, torch.from_numpy(bits.astype(np.int64)),
                              pt["pos"], pt["uf"], pt["itf"], hp,
                              port.BatchConfig(*cfg), n_item)


def _cfg(loss, kernel, optimizer, S=64, K=6):
    return (S, K, {"bpr": ref.BPR, "warp": ref.WARP}[loss],
            {"identity": ref.IDENTITY, "sigmoid": ref.SIGMOID}[kernel],
            {"adagrad": ref.ADAGRAD, "rmsprop": ref.RMSPROP}[optimizer],
            True)


@pytest.mark.parametrize("features", FEATURES)
@pytest.mark.parametrize("optimizer", ["adagrad", "rmsprop"])
@pytest.mark.parametrize("kernel", ["identity", "sigmoid"])
@pytest.mark.parametrize("loss", ["bpr", "warp"])
def test_bf16_batch_matches_reference(loss, kernel, optimizer, features):
    """One batch from the same bf16 tables with the reference's bits: op
    by op every cell and the counters equal; jitted the counters equal and
    at most JIT_SHARE of the cells apart."""
    x, init, jx, jf, pt = _problem(features)
    cfg = _cfg(loss, kernel, optimizer)
    key = jax.random.PRNGKey(100)
    tj0 = [jnp.asarray(a, BF) for a in init]
    tt = [torch.tensor(a, dtype=torch.bfloat16) for a in init]
    for a, b in zip(tt, tj0):   # the casts agree (through float32)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    c = _port_batch(tt, key, pt, cfg, x.shape[1])
    assert all(t.dtype == torch.bfloat16 for t in tt)
    apart = 0
    for jit in (False, True):
        *tj, an, ad, nf, nt = _jax_batch(tj0, key, jx, jf, cfg, x.shape[1],
                                         BF, jit)
        assert c.tolist() == [int(an), int(ad), int(nf), int(nt)], jit
        for name, a, b in zip(("W", "H", "accW", "accH"), tt, tj):
            a, b = a.float().numpy(), np.asarray(b, np.float32)
            if not jit:
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                apart += int((a != b).sum())
    cells = sum(t.numel() for t in tt)
    print(f"{loss} {kernel} {optimizer} {features}: {apart} of {cells} "
          "cells apart from the jitted JAX batch")
    assert apart <= JIT_SHARE * cells
    assert int(c[2]) > 0


@pytest.mark.parametrize("mode", [("warp", "sigmoid", "rmsprop", "side"),
                                  ("bpr", "identity", "adagrad",
                                   "duplicates")])
def test_bf16_chained_batches(mode):
    """20 batches in a row against the jitted JAX bf16 fit on the same bits:
    the largest difference at most CHAIN_MAX and below the JAX package's
    own bf16-to-float32 distance."""
    loss, kernel, optimizer, features = mode
    x, init, jx, jf, pt = _problem(features)
    cfg = _cfg(loss, kernel, optimizer)
    tj = [jnp.asarray(a, BF) for a in init]
    tf = [jnp.asarray(a, jnp.float32) for a in init]
    tt = [torch.tensor(a, dtype=torch.bfloat16) for a in init]
    for b in range(20):
        key = jax.random.PRNGKey(200 + b)
        for tabs, dt in ((tj, BF), (tf, jnp.float32)):
            out = JAX_STEP(OPS, *tabs, key, jx["flat"], jx["indptr"],
                       jx["row_nnz"], jx["uhash"], *(
                           (None if f is None else ref._Feats(
                               f.idx, f.val.astype(dt), f.mask))
                           for f in jf),
                       *(jnp.asarray(v, dt) for v in HP), cfg, x.shape[1],
                       ref._MAX_PROBE)
            tabs[:] = out[:4]
        _port_batch(tt, key, pt, cfg, x.shape[1])
    port_d = max(float(np.abs(a.float().numpy() - np.asarray(b, np.float32))
                       .max()) for a, b in zip(tt, tj))
    jax_d = max(float(np.abs(np.asarray(a, np.float32)
                             - np.asarray(b, np.float32)).max())
                for a, b in zip(tj, tf))
    print(f"{mode}: port vs JAX bf16 {port_d:.3g}, JAX bf16 vs f32 "
          f"{jax_d:.3g}")
    assert port_d <= CHAIN_MAX and port_d < jax_d


def test_rule1_scatter_stalls_as_the_reference():
    """A scatter-add of bf16 updates rounds once a duplicate: 100 adds of
    0.003 to 1.0 leave it at 1.0 in both packages (one rounding of the sum
    would give 1.296875)."""
    one = jnp.ones(1, BF).at[jnp.zeros(100, jnp.int32)].add(
        jnp.full(100, 0.003, BF))
    t = ordered_add_(torch.ones(1, dtype=torch.bfloat16),
                     torch.zeros(100, dtype=torch.long),
                     torch.full((100,), 0.003, dtype=torch.bfloat16))
    assert float(t[0]) == float(np.asarray(one, np.float32)[0]) == 1.0
    once = torch.ones(1).index_add_(0, torch.zeros(100, dtype=torch.long),
                                    torch.full((100,), 0.003)).bfloat16()
    assert float(once[0]) == 1.296875


def test_rule1_hot_accumulator_stalls_in_a_batch():
    """K9's plain version on a batch whose four users repeat ~16 times: each
    AdaGrad increment g^2 / r of a hot user's accumulator is below half its
    bf16 spacing, so the accumulator stays at its batch-start value, as
    in the JAX package, though the increments sum past a spacing."""
    x, init, jx, jf, pt = _problem("duplicates", scale=0.05)
    init[2] = np.full_like(init[2], 1.0)    # spacing 2^-7 at 1
    cfg = _cfg("bpr", "identity", "adagrad")
    key = jax.random.PRNGKey(7)
    tj0 = [jnp.asarray(a, BF) for a in init]
    tt = [torch.tensor(a, dtype=torch.bfloat16) for a in init]
    _port_batch(tt, key, pt, cfg, x.shape[1])
    *tj, _, _, _, _ = _jax_batch(tj0, key, jx, jf, cfg, x.shape[1], BF,
                                 False)
    np.testing.assert_array_equal(tt[2].float().numpy(),
                                  np.asarray(tj[2], np.float32))
    # the float32 sum of the same increments would have moved them
    S, K = cfg[0], cfg[1]
    bits = np.asarray(jax.random.bits(key, (S, K + 2), jnp.uint32))
    users = bits[:, 0].astype(np.int64) % x.shape[0]
    assert np.bincount(users).max() >= 10
    assert (tt[2].float().numpy() == 1.0).all()
    tw = [torch.tensor(a, dtype=torch.float32) for a in init]
    hp = port.BatchParams(*(port.bf16_value(v) for v in HP))
    port._rankmf_batch(*tw, torch.from_numpy(bits.astype(np.int64)),
                       pt["pos"], None, None, hp, port.BatchConfig(*cfg),
                       x.shape[1])
    moved = tw[2].to(torch.bfloat16).float().numpy() != 1.0
    assert moved.any()


@pytest.fixture(scope="module")
def ml100k_bf16():
    x = rt.load_movielens100k()
    train, test = rt.train_test_split(x, 0.2, np.random.default_rng(0))
    tr = sp.csr_matrix(train)
    kw = dict(rank=16, learning_rate=0.5, loss="bpr", seed=0,
              batch_size=2048, precision="bfloat16")
    mj = rt_ref.RankMF(**kw)
    mj.partial_fit_transform(tr, n_iter=200)
    pj = mj.predict(tr, k=10, not_recommend=tr)
    mj.ndcg = float(np.nanmean(rt_ref.ndcg_k(pj.indices, test)))
    m = rt.RankMF(**kw, device="cpu")
    emb = m.partial_fit_transform(tr, n_iter=200)
    return tr, test, m, emb, mj


def test_bf16_ml100k_quality(ml100k_bf16):
    """BPR rank 16 at bf16: AUC within 0.01 of the JAX package's bf16 fit
    (its own bits), AUC > 0.8 and NDCG@10 > 0.15 through predict, every
    table bf16."""
    tr, test, m, emb, mj = ml100k_bf16
    assert emb.dtype == torch.bfloat16 and all(
        t.dtype == torch.bfloat16 for t in (
            m.user_features_embeddings, m.item_features_embeddings, m._accW,
            m._accH))
    assert abs(m.auc_history[-1] - mj.auc_history[-1]) <= 0.01
    assert m.auc_history[-1] > 0.8
    preds = m.predict(tr, k=10, not_recommend=tr)
    ndcg = float(np.nanmean(rt.ndcg_k(preds.indices, test)))
    assert ndcg > 0.15, ndcg
    from chip_smoke import REF_BF16, REF_BF16_KW
    assert dict(rank=16, learning_rate=0.5, loss="bpr", seed=0,
                batch_size=2048, precision="bfloat16") == REF_BF16_KW["rankmf"]
    np.testing.assert_allclose((mj.auc_history[-1], mj.ndcg),
                               REF_BF16["rankmf"], rtol=0, atol=1e-4)
