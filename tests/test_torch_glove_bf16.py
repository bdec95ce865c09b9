"""GloVe at ``precision="bfloat16"`` (K10's and K11's bf16 plain versions)
against the JAX package's bf16 GloVe on the CPU.

The same numpy-made co-occurrences and states, cast to bf16 as both
packages cast them, go through ``rsparse_tpu/models/glove.py`` and the
port's wrappers, which run the kernels' plain PyTorch versions on CPU
tensors.  Stated tolerances:

- one tail epoch on each tail path (the scatter path, shuffle on; the
  scheduled sums, shuffle off), with few and with more than 128 entries of
  a feature in a shard (the scheduled sums' chunks), against the JAX
  function run op by op (``jax.disable_jit``): every cell of the eight
  tables and the loss equal; jitted, at most ``TAIL_JIT_SHARE`` of the
  cells apart (XLA's CPU fusions skip some bf16 roundings, most of all in
  the sums and steps of the biases);
- one head tile at r = 4 and r = 130 against the JAX function run op by
  op: the embeddings and their accumulators equal but for the cells whose
  bf16 S lies at a rounding midpoint of an f32 sum (at most
  ``TILE_W_APART``), the biases and their accumulators at most
  ``TILE_B_SHARE`` apart: the reference sums a tile's cost and cost^2 per
  row and column with ``jnp.sum(..., dtype=bf16)``, which XLA's CPU
  compiler accumulates at bf16 in its own order; the port sums at float32
  and rounds once;
- fits on a triangular input: shuffle off on ML-100k (REF_BF16's
  setting), shuffle on (the JAX package's permutation injected) on a
  synthetic: each epoch's cost within ``FIT_REL`` of the JAX package's bf16
  history, the last within a quarter of the JAX package's own bf16-to-
  float32 gap, which is at least 1% on both shapes; every table bf16.  The
  ML-100k fit's JAX history is ``chip_smoke.REF_BF16["glove"]`` (held here
  to 1e-5 relative), which the card's fit is held to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu.models import glove as ref_glove
from rsparse_tpu.ops.segsum import build_stacked_col_schedule
from rsparse_tpu_torch.models import glove as port_glove

torch.set_num_threads(2)

BF = jnp.bfloat16
HP = dict(x_max=10.0, alpha=0.75, lr=0.05)
FIT_REL = 2e-3
#: jitted JAX tail epochs: share of the eight tables' cells apart (twice
#: the largest measured, 179 of 480 on the scheduled path with 20 tokens)
TAIL_JIT_SHARE = 0.75
#: op-by-op JAX head tile: embedding and accumulator cells apart (twice the
#: largest measured, 1) and the share of bias cells apart (twice the
#: largest measured, 75 of 300)
TILE_W_APART = 2
TILE_B_SHARE = 0.5


def _cooc(n, density, seed, scale=10.0):
    m = sp.random(n, n, density=density, random_state=seed, format="coo")
    m.data = 1.0 + scale * m.data
    return m


def _states(n, r, seed):
    rng = np.random.default_rng(seed)
    a = [rng.uniform(-0.5, 0.5, s) for s in ((n, r), (n, r), (n,), (n,))]
    a += [rng.uniform(1.0, 2.0, s) for s in ((n, r), (n, r), (n,), (n,))]
    return (ref_glove.GloveState(*(jnp.asarray(x, BF) for x in a)),
            port_glove.GloveState(*(torch.tensor(x, dtype=torch.bfloat16)
                                    for x in a)))


def _apart(st, sj):
    return [int((a.float().numpy() != np.asarray(b, np.float32)).sum())
            for a, b in zip(st, sj)]


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("path", ["scatter", "scheduled"])
def test_bf16_tail_epoch_matches_reference(path, many):
    """A tail epoch (``many``: 20 tokens in a shard of 8192, so a token
    holds ~360 entries of it) on the path of each shuffle setting, op by op
    bitwise and jitted by share."""
    n, r, bs = (20, 5, 8192) if many else (60, 5, 256)
    coo = _cooc(n, 0.9 if many else 0.15, 1)
    if many:
        coo = sp.coo_matrix(sp.vstack([coo] * 20))  # repeated triplets
        coo = sp.coo_matrix((coo.data, (coo.row % n, coo.col)),
                            shape=(n, n))
    host = ref_glove._stack_coo_host(coo, bs)
    counts = np.bincount(host[0][0][host[3][0]])
    assert (counts.max() > 128) == many
    shards = port_glove.Shards.build(*(torch.from_numpy(a) for a in host[:2]),
                                     torch.from_numpy(host[2]).to(
                                         torch.bfloat16),
                                     torch.from_numpy(host[3]))
    jsh = (jnp.asarray(host[0]), jnp.asarray(host[1]),
           jnp.asarray(host[2], BF), jnp.asarray(host[3]))
    sj0, st = _states(n, r, 2)
    if path == "scatter":
        fn = lambda: ref_glove._glove_epoch_impl(  # noqa: E731
            ref_glove._DIRECT, sj0, *jsh, **HP)
    else:
        sr = build_stacked_col_schedule(host[0], host[3], n)
        sc = build_stacked_col_schedule(host[1], host[3], n)
        fn = lambda: ref_glove._glove_epoch_sched_impl(  # noqa: E731
            ref_glove._DIRECT, sj0, *jsh, sr, sc, **HP)
    lt = port_glove._glove_epoch(st, shards, **HP,
                                 ordered=path == "scatter")
    assert all(t.dtype == torch.bfloat16 for t in st)
    with jax.disable_jit():
        sj, lj = fn()
    assert float(lt) == float(lj)
    assert _apart(st, sj) == [0] * 8
    sj, lj = jax.jit(fn)()
    apart = _apart(st, sj)
    print(f"{path} many={many}: cells apart from the jitted epoch {apart}")
    assert sum(apart) <= TAIL_JIT_SHARE * sum(t.numel() for t in st)


@pytest.mark.parametrize("r", [4, 130])
def test_bf16_head_tile_matches_reference(r):
    """One head tile of 200 hot tokens (r = 130: the wide route's width)
    against the JAX function run op by op."""
    n, H = 300, 200
    rng = np.random.default_rng(3)
    hot = np.sort(rng.choice(n, H, replace=False)).astype(np.int32)
    X = np.where(rng.random((H, H)) < 0.3,
                 1.0 + rng.exponential(8.0, (H, H)), 0.0).astype(np.float32)
    grids = ref_glove._head_grids(X, hot, BF, 1 << 20)
    head = port_glove._stage_head(X, hot, torch.bfloat16, 1 << 20, "cpu")
    assert head.nt == 1
    sj0, st = _states(n, r, 4)
    lt = port_glove._glove_dense_step(st, head, **HP, cdt=torch.bfloat16)
    with jax.disable_jit():
        sj, lj = ref_glove._glove_dense_step_impl(ref_glove._DIRECT, sj0,
                                                  *grids, **HP)
    apart = _apart(st, sj)
    fields = port_glove.GloveState._fields
    print(f"r={r}: cells apart {dict(zip(fields, apart))}, loss "
          f"{float(lt)} vs {float(lj)}")
    w_apart = apart[0] + apart[1] + apart[4] + apart[5]
    b_apart = apart[2] + apart[3] + apart[6] + apart[7]
    assert w_apart <= TILE_W_APART
    assert b_apart <= TILE_B_SHARE * 4 * n
    assert float(lt) == float(lj)


def _inject_jax_shuffles(monkeypatch):
    """The port's shuffle draws the JAX package's permutation from the same
    seed (rsparse_tpu/models/glove.py:618-619)."""
    orig = port_glove._shuffle_shards

    def shuffle(shards, seed=None, perm=None):
        if perm is None:
            perm = torch.from_numpy(np.asarray(jax.random.permutation(
                jax.random.PRNGKey(seed), shards.rows.numel())))
        return orig(shards, perm=perm)
    monkeypatch.setattr(port_glove, "_shuffle_shards", shuffle)


def _ml100k_triu():
    from chip_smoke import ml100k_cooccurrence
    return sp.triu(ml100k_cooccurrence(rt.load_movielens100k())).tocoo()


def _synthetic_triu():
    from chip_smoke import synth_glove
    return sp.triu(synth_glove(400, 20000, seed=3)).tocoo()


FITS = {
    "ml100k_no_shuffle": (_ml100k_triu, dict(rank=16, x_max=10.0,
                                             learning_rate=0.05, n_hot=256,
                                             seed=0), 3),
    "synthetic_shuffle": (_synthetic_triu, dict(rank=8, x_max=100.0,
                                                learning_rate=0.05,
                                                n_hot=64, seed=0,
                                                batch_size=512,
                                                shuffle=True), 4)}


@pytest.mark.parametrize("case", list(FITS))
def test_bf16_fit_matches_reference(case, monkeypatch):
    """Whole fits on a triangular input: each epoch within FIT_REL of the
    JAX package's bf16 history, the last within a quarter of its own
    bf16-to-float32 gap (at least 1% here), every table bf16."""
    make, kw, n_iter = FITS[case]
    x = make()
    if kw.get("shuffle"):
        _inject_jax_shuffles(monkeypatch)
    hist = {}
    for prec in ("bfloat16", "float32"):
        m = rt_ref.GloVe(**kw, precision=prec)
        m.fit_transform(x, n_iter=n_iter)
        hist[prec] = m.cost_history
    m = rt.GloVe(**kw, precision="bfloat16", device="cpu")
    emb = m.fit_transform(x, n_iter=n_iter)
    assert emb.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in m._state)
    got, jb, jf = m.cost_history, hist["bfloat16"], hist["float32"]
    rels = [abs(a / b - 1) for a, b in zip(got, jb)]
    gap = abs(jb[-1] - jf[-1])
    print(f"{case}: port {got}, JAX bf16 {jb}, JAX f32 {jf}; relative "
          f"{rels}; gap {gap / jf[-1]:.3%}")
    assert len(got) == n_iter and max(rels) <= FIT_REL
    if case == "ml100k_no_shuffle":
        from chip_smoke import REF_BF16, REF_BF16_KW
        assert kw == {k: v for k, v in REF_BF16_KW["glove"].items()
                      if k != "precision"}
        np.testing.assert_allclose(jb, REF_BF16["glove"], rtol=1e-5)
    assert gap >= 0.01 * jf[-1]
    assert abs(got[-1] - jb[-1]) <= gap / 4
    assert abs(got[-1] - jb[-1]) < abs(got[-1] - jf[-1])


def test_bf16_state_takes_the_bf16_head_only():
    """compute_dtype None and "bfloat16" run the reference's bf16-state
    program; "float32" over bf16 state is not ported and raises."""
    assert rt.GloVe(rank=4, x_max=10, precision="bfloat16",
                    device="cpu")._cdt == torch.bfloat16
    assert rt.GloVe(rank=4, x_max=10, precision="bfloat16",
                    compute_dtype="bfloat16",
                    device="cpu")._cdt == torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rt.GloVe(rank=4, x_max=10, precision="bfloat16",
                 compute_dtype="float32", device="cpu")


def test_convert_takes_jax_bf16_arrays():
    """``convert`` carries the JAX package's bf16 parameters across bit for
    bit: ``np.asarray`` of a JAX bf16 array (a 2-byte bfloat16 numpy
    array) and a float32 array of the same values give the same bf16
    tables (RankMF, GloVe state, GloVe model)."""
    from rsparse_tpu_torch import convert
    x = (sp.random(30, 20, density=0.2, random_state=4) > 0).astype(
        np.float64).tocsr()
    mj = rt_ref.RankMF(rank=4, learning_rate=0.1, seed=0,
                       precision="bfloat16")
    mj.partial_fit_transform(x, n_iter=2)
    tabs = (mj.user_features_embeddings, mj.item_features_embeddings,
            mj._accW, mj._accH)
    raw = [np.asarray(t) for t in tabs]
    assert raw[0].dtype.itemsize == 2 and raw[0].dtype.name == "bfloat16"
    for arrays in (raw, [np.asarray(t, np.float32) for t in tabs]):
        m = convert.rankmf_from_numpy(*arrays, precision="bfloat16",
                                      device="cpu")
        for name, want in zip(("user_features_embeddings",
                               "item_features_embeddings", "_accW", "_accH"),
                              tabs):
            got = getattr(m, name)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
        np.testing.assert_array_equal(m.components,
                                      np.asarray(mj.components, np.float64))
    g = rt_ref.GloVe(rank=4, x_max=10.0, seed=0, precision="bfloat16",
                     n_hot=0)
    s = sp.csr_matrix(x).sign()
    emb = g.fit_transform((s.T @ s).tocoo(), n_iter=2)
    st = convert.glove_state_from_numpy([np.asarray(t) for t in g._state],
                                        "bfloat16", "cpu")
    for a, b in zip(st, g._state):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    c = convert.glove_from_numpy(np.asarray(emb), np.asarray(g.components).T,
                                 np.asarray(g.bias_i), np.asarray(g.bias_j),
                                 x_max=10.0, precision="bfloat16",
                                 device="cpu")
    assert c.dtype == torch.bfloat16
    np.testing.assert_array_equal(c.components,
                                  np.asarray(g.components, np.float32))
    np.testing.assert_array_equal(c.bias_j, np.asarray(g.bias_j, np.float32))
