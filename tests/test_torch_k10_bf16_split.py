"""K10's bf16 instance (``csrc/glove.cu`` ``glove_bf16_cost`` /
``glove_bf16_walk`` / ``glove_bf16_final``, GloVe at
``precision="bfloat16"``) replayed in plain torch on the CPU.

The kernel spreads a shard side's features over CTAs by the side's work
list (``ops/segsum.py`` ``k10_work_lists``): a chunk of 128 entries of a
long feature, a feature of its own, or the short features of one window of
32 entries of the order.  Launch E forms each valid entry's cost once;
on the scheduled path (shuffle off) launch S sums each item's features at
float32 in entry order, a chunk of a long feature rounding its sums into a
chunk slot, and launch F adds a long feature's chunk slots in chunk order
and steps it; on the ordered path (shuffle on) one CTA walks a whole
feature, a thread a component, as the chain of rounded accumulator adds and
then the chain of rounded row adds.  :func:`_replay` does exactly that from
the shard's work lists, with the entries' costs formed as the plain
version forms them; it is held bitwise (every cell of the eight tables)
against ``models/glove.py`` ``_glove_shard_plain_bf16`` on both paths at r
= 16, 40 and 300, on shards with features of exactly 128, 129 and 600
entries, an id present on the column side only, padding entries and an
empty shard (its loss within one bf16 spacing: the kernel sums the loss
terms by tiles of 32 entries), and against the JAX package's bf16 tail
epochs run op by op on a shard with a feature over more than three chunks.
The work lists themselves are tested directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rsparse_tpu.models import glove as ref_glove
from rsparse_tpu.ops.segsum import build_stacked_col_schedule
from rsparse_tpu_torch.config import bf16_value
from rsparse_tpu_torch.config import round_bf16 as rb
from rsparse_tpu_torch.models import glove
from rsparse_tpu_torch.ops import segsum

torch.set_num_threads(2)

X_MAX, ALPHA, LR = 10.0, 0.75, 0.05
CHUNK, PACK = segsum.SCHED_CHUNK, segsum.K10_PACK
#: entries a tile of launch E (its loss partials) takes (csrc/glove.cu
#: kTile)
E_TILE = 32


def _shards(r, seed, n_tok=400, N=2048, hot=(128, 129, 600)):
    """Two stacked shards of N entries: shard 0 holds row features of
    exactly ``hot`` entries, a column feature of 300, an id (n_tok - 1)
    that only the column side holds, short features and 100 padding
    entries at its end; shard 1 is empty.  Returns (Shards, state)."""
    rng = np.random.default_rng(seed)
    n_valid = N - 100
    rows = [np.full(h, k, np.int64) for k, h in enumerate(hot)]
    rest = n_valid - sum(hot)
    rows.append(rng.integers(len(hot), n_tok - 1, rest))
    rows = np.concatenate(rows)
    cols = rng.integers(0, n_tok - 1, n_valid)
    cols[rng.permutation(n_valid)[:300]] = n_tok - 2     # a long column
    cols[rng.permutation(n_valid)[:7]] = n_tok - 1       # columns only
    perm = rng.permutation(n_valid)                      # entry order
    rows, cols = rows[perm], cols[perm]
    vals = 1.0 + rng.exponential(6.0, n_valid)
    S = 2
    R = np.zeros((S, N), np.int32)
    C = np.zeros((S, N), np.int32)
    V = np.ones((S, N))
    M = np.zeros((S, N), bool)
    R[0, :n_valid], C[0, :n_valid], V[0, :n_valid] = rows, cols, vals
    M[0, :n_valid] = True
    sh = glove.Shards.build(torch.from_numpy(R), torch.from_numpy(C),
                            torch.from_numpy(V).to(torch.bfloat16),
                            torch.from_numpy(M))
    a = [rng.uniform(-0.5, 0.5, s) for s in ((n_tok, r), (n_tok, r),
                                             (n_tok,), (n_tok,))]
    a += [rng.uniform(1.0, 2.0, s) for s in ((n_tok, r), (n_tok, r),
                                             (n_tok,), (n_tok,))]
    st = glove.GloveState(*(torch.tensor(x, dtype=torch.bfloat16)
                            for x in a))
    return sh, st


def _costs(st, sh):
    """Each entry's cost and loss term (float32 holding bf16 values), as
    the plain version forms them; zero at padding."""
    N = sh.rows.shape[0]
    valid = sh.slot_r < sh.feats_r.shape[0]
    i, j = sh.rows.long(), sh.cols.long()
    v = sh.vals.float()
    wi, wj = st.w_i[i].float(), st.w_j[j].float()
    dot = rb(rb(wi * wj).sum(1))
    inner = torch.clamp(rb(rb(rb(dot + st.b_i[i].float())
                              + st.b_j[j].float()) - rb(torch.log(v))),
                        -100.0, 100.0)
    cost = rb(glove._weight_bf16(v, X_MAX, ALPHA) * inner)
    zero = torch.zeros(N)
    return torch.where(valid, cost, zero), torch.where(
        valid, rb(cost * inner), zero)


def _sides(st, sh):
    """Per side: (own ids, the other side's slot of each entry, order,
    bounds, feats, work list, own tables, the other side's shard-start
    rows [w | b] by slot)."""
    snap_r = torch.cat([st.w_i[sh.feats_r.long()].float(),
                        st.b_i[sh.feats_r.long()].float()[:, None]], 1)
    snap_c = torch.cat([st.w_j[sh.feats_c.long()].float(),
                        st.b_j[sh.feats_c.long()].float()[:, None]], 1)
    return ((sh.rows, sh.slot_c, sh.order_r, sh.bounds_r, sh.feats_r,
             sh.work_r, st[0::2], snap_c),
            (sh.cols, sh.slot_r, sh.order_c, sh.bounds_c, sh.feats_c,
             sh.work_c, st[1::2], snap_r))


def _step(w, acc, f, s1, s2, nlr):
    """The scheduled sums' step: acc + s2 rounded, -lr s1 / sqrt(acc) op
    by op, one rounded add (step_bf16)."""
    av = rb(acc[f].float() + s2)
    w[f] = (w[f].float() + rb(rb(nlr * s1) / rb(torch.sqrt(av)))).to(
        torch.bfloat16)
    acc[f] = av.to(torch.bfloat16)


def _replay(st, sh, ordered):
    """K10's bf16 instance on ``sh`` from its work lists; updates st in
    place and returns (the loss as launches E and F sum it, each side's
    visits of each valid entry)."""
    r = st.w_i.shape[1]
    N = sh.rows.shape[0]
    cost, lterm = _costs(st, sh)
    nlr = bf16_value(-LR)
    visits = []
    for own, other, order, bounds, feats, work, tabs, snap in _sides(st,
                                                                     sh):
        w, b, acc_w, acc_b = tabs
        seen = torch.zeros(N, dtype=torch.int64)
        csum = {}
        for e0, e1, q, end in work.items.tolist():
            if ordered:
                if end < 0:
                    continue                     # a later chunk
                e1 = end
            ents = order[e0:e1].long()
            seen[ents] += 1
            fs = own[ents].long()
            if not ordered:
                s = torch.zeros(2 * r + 2)
                for t, p in enumerate(ents.tolist()):
                    f = int(fs[t])
                    if q < 0 and (t == 0 or int(fs[t - 1]) != f):
                        s = torch.zeros(2 * r + 2)
                    c = cost[p]
                    g = rb(c * snap[other[p], :r])
                    s = s + torch.cat([g, rb(g * g), c.reshape(1),
                                       rb(c * c).reshape(1)])
                    if q < 0 and (t == len(ents) - 1
                                  or int(fs[t + 1]) != f):
                        tot = rb(0.0 + rb(s))       # one chunk
                        _step(w, acc_w, f, tot[:r], tot[r:2 * r], nlr)
                        _step(b, acc_b, f, tot[2 * r], tot[2 * r + 1], nlr)
                if q >= 0:
                    csum[q] = rb(s)
                continue
            # the ordered scatter: each feature's two chains
            t = 0
            while t < len(ents):
                f = int(fs[t])
                t1 = t
                while t1 < len(ents) and int(fs[t1]) == f:
                    t1 += 1
                ps = ents[t:t1].tolist()
                a, ab = acc_w[f].float(), acc_b[f].float()
                for p in ps:
                    g = rb(cost[p] * snap[other[p], :r])
                    a = rb(a + rb(g * g))
                    ab = rb(ab + rb(cost[p] * cost[p]))
                dv, db = rb(torch.sqrt(a)), rb(torch.sqrt(ab))
                wv, bv = w[f].float(), b[f].float()
                for p in ps:
                    g = rb(cost[p] * snap[other[p], :r])
                    wv = rb(wv + rb(rb(nlr * g) / dv))
                    bv = rb(bv + rb(rb(nlr * cost[p]) / db))
                w[f], acc_w[f] = wv.to(torch.bfloat16), a.to(torch.bfloat16)
                b[f], acc_b[f] = bv.to(torch.bfloat16), ab.to(torch.bfloat16)
                t = t1
        if not ordered:                          # launch F
            for u, q0 in work.multi.tolist():
                n = int(bounds[u + 1] - bounds[u])
                tot = torch.zeros(2 * r + 2)
                for c in range(-(-n // CHUNK)):
                    tot = tot + csum[q0 + c]
                tot = rb(tot)
                f = int(feats[u])
                _step(w, acc_w, f, tot[:r], tot[r:2 * r], nlr)
                _step(b, acc_b, f, tot[2 * r], tot[2 * r + 1], nlr)
        visits.append(seen)
    # launch E's partials (tiles of 32 entries of the row order), then F
    n_valid = int(sh.bounds_r[-1])
    parts = [lterm[sh.order_r[a:min(a + E_TILE, n_valid)].long()]
             for a in range(0, n_valid, E_TILE)]
    loss = torch.zeros(())
    for part in parts:
        lp = torch.zeros(())
        for v in part:
            lp = lp + v
        loss = loss + lp
    return rb(loss), visits


def _hold_bitwise(sh, st, ordered, s=0):
    shard = sh.shard(s)
    sk = glove.GloveState(*(t.clone() for t in st))
    sp = glove.GloveState(*(t.clone() for t in st))
    lk, visits = _replay(sk, shard, ordered)
    lp = glove._glove_shard_plain_bf16(sp, shard, X_MAX, ALPHA, LR, ordered)
    for name, a, b in zip(glove.GloveState._fields, sk, sp):
        assert torch.equal(a, b), name
    spacing = 2.0 ** (np.floor(np.log2(max(abs(float(lp)), 1e-30))) - 7)
    assert abs(float(lk) - float(lp)) <= spacing
    valid = shard.slot_r < shard.feats_r.shape[0]
    for v in visits:                     # every valid entry once a side
        assert bool((v[valid] == 1).all()) and int(v[~valid].sum()) == 0
    return sk


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("r", [16, 40, 300])
def test_replay_matches_plain_bitwise(r, ordered):
    sh, st = _shards(r, r + 3 * ordered)
    _hold_bitwise(sh, st, ordered)


@pytest.mark.parametrize("ordered", [False, True])
def test_empty_shard_changes_nothing(ordered):
    sh, st = _shards(16, 5)
    shard = sh.shard(1)
    assert shard.work_r.items.shape[0] == 0
    assert shard.work_c.multi.shape[0] == 0
    sk = glove.GloveState(*(t.clone() for t in st))
    lk, _ = _replay(sk, shard, ordered)
    assert float(lk) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(sk, st))


def _check_work(bounds, work, N):
    """What csrc/glove.cu's launches S and F assume of a side's work
    list."""
    b = bounds.tolist()
    U, n_valid = len(b) - 1, b[-1]
    starts = set(b[:-1])
    ends = set(b[1:])
    length = {b[u]: b[u + 1] - b[u] for u in range(U)}
    feat_end = {b[u]: b[u + 1] for u in range(U)}
    cover = np.zeros(n_valid, np.int64)
    walked = np.zeros(n_valid, np.int64)
    keys = []
    slots = {}
    for e0, e1, q, end in work.items.tolist():
        assert 0 <= e0 < e1 <= n_valid and e1 - e0 <= CHUNK
        cover[e0:e1] += 1
        if q < 0:                            # whole features
            assert e0 in starts and e1 in ends and end == e1
            inner = [s for s in starts if e0 <= s < e1]
            if len(inner) > 1:               # short ones of one window
                assert e0 // PACK == (e1 - 1) // PACK
                assert all(length[s] <= PACK for s in inner)
            keys.append(-(e1 - e0))
            walked[e0:e1] += 1
        else:                                # a chunk of a long feature
            s0 = max(s for s in starts if s <= e0)
            assert length[s0] > CHUNK and (e0 - s0) % CHUNK == 0
            assert e1 == min(e0 + CHUNK, feat_end[s0])
            slots.setdefault(s0, []).append(q)
            assert end == (feat_end[s0] if e0 == s0 else -1)
            if end > 0:
                walked[e0:end] += 1
            keys.append(-length[s0])
    assert (cover == 1).all() and (walked == 1).all()
    assert keys == sorted(keys)              # longest features first
    multi = work.multi.tolist()
    assert len(multi) == len(slots) and len(multi) <= N // 64 + 1
    q_next = 0
    for u, q0 in multi:
        qs = sorted(slots[b[u]])
        n_chunks = -(-length[b[u]] // CHUNK)
        assert qs == list(range(q0, q0 + n_chunks)) and q0 == q_next
        q_next += n_chunks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_work_lists(seed):
    """Every valid entry in exactly one item of at most 128 entries (the
    ordered view: every feature walked once, from its first chunk); short
    features packed within one window of 32; chunk slots consecutive a
    feature, from 0 a shard; items longest feature first."""
    rng = np.random.default_rng(seed)
    S, N = 3, 4096
    ids = torch.from_numpy(np.minimum(rng.zipf(1.3, (S, N)), 3000)
                           .astype(np.int32))
    valid = torch.from_numpy(rng.random((S, N)) < 0.95)
    valid[2] = False
    m = segsum.shard_slot_maps(ids, valid)
    assert len(m.item_offs) == len(m.multi_offs) == S + 1
    for s in range(S):
        _, _, _, bounds = m.shard(s)
        work = m.work(s)
        if s == 2:
            assert work.items.shape[0] == work.multi.shape[0] == 0
            continue
        assert int((bounds[1:] - bounds[:-1]).max()) > 3 * CHUNK
        _check_work(bounds, work, N)


@pytest.mark.parametrize("path", ["scatter", "scheduled"])
def test_replay_matches_jax_op_by_op(path):
    """One shard whose row token 3 holds 600 entries (five chunks), the
    JAX package's bf16 tail epoch (rsparse_tpu/models/glove.py:50 and
    :109) run op by op against the replay: every cell equal."""
    rng = np.random.default_rng(7)
    n, r, bs = 40, 6, 1024
    rows = np.concatenate([np.full(600, 3), rng.integers(0, n, 300)])
    cols = rng.integers(0, n, 900)
    coo = sp.coo_matrix((1.0 + rng.exponential(5.0, 900), (rows, cols)),
                        shape=(n, n))
    host = ref_glove._stack_coo_host(coo, bs)
    assert host[0].shape[0] == 1
    shards = glove.Shards.build(*(torch.from_numpy(a) for a in host[:2]),
                                torch.from_numpy(host[2]).to(torch.bfloat16),
                                torch.from_numpy(host[3]))
    assert int(shards.shard(0).work_r.multi.shape[0]) >= 1
    a = [rng.uniform(-0.5, 0.5, s) for s in ((n, r), (n, r), (n,), (n,))]
    a += [rng.uniform(1.0, 2.0, s) for s in ((n, r), (n, r), (n,), (n,))]
    bf = jnp.bfloat16
    sj0 = ref_glove.GloveState(*(jnp.asarray(x, bf) for x in a))
    st = glove.GloveState(*(torch.tensor(x, dtype=torch.bfloat16)
                            for x in a))
    jsh = (jnp.asarray(host[0]), jnp.asarray(host[1]),
           jnp.asarray(host[2], bf), jnp.asarray(host[3]))
    hp = dict(x_max=X_MAX, alpha=ALPHA, lr=LR)
    with jax.disable_jit():
        if path == "scatter":
            sj, lj = ref_glove._glove_epoch_impl(ref_glove._DIRECT, sj0,
                                                 *jsh, **hp)
        else:
            sr = build_stacked_col_schedule(host[0], host[3], n)
            sc = build_stacked_col_schedule(host[1], host[3], n)
            sj, lj = ref_glove._glove_epoch_sched_impl(
                ref_glove._DIRECT, sj0, *jsh, sr, sc, **hp)
    lk, _ = _replay(st, shards.shard(0), path == "scatter")
    for name, p, q in zip(glove.GloveState._fields, st, sj):
        assert np.array_equal(p.float().numpy(),
                              np.asarray(q, np.float32)), name
    spacing = 2.0 ** (np.floor(np.log2(abs(float(lj)))) - 7)
    assert abs(0.5 * float(lk) - float(lj)) <= spacing
