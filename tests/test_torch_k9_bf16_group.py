"""K9's bf16 instance groups its updates on the device
(``csrc/rankmf.cu``): replayed in plain torch on the CPU against
``models/rankmf.py`` ``_walk_pairs``, the plain oracle of the order.

Launch A writes each update's table row (-1 where it changes nothing: a
masked feature slot, or a sample without an acceptable negative) at its
rank in the reference's scatter order: W's rank s Fw + l, H's the
positives' (s, l), then the negatives'.  Launch G sorts each chunk of a
table's list by row with a stable LSD radix sort, 8 bits a pass over only
the bits the chunk's largest row needs (a -1 sorts last), and lists the
starts of its runs.  Launch W walks every run of a row in its first chunk,
followed by the row's runs in the later chunks.  :func:`_device_order`
replays the three and must give, row by row, the update order that
``_walk_pairs``' stable ``torch.sort`` gives: W and H, with and without
side features, in row-map mode, with -1 keys, a hot row with more than 32
updates, and tables of several chunks.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu_torch as rt
from rsparse_tpu_torch.models import rankmf

torch.set_num_threads(2)

#: pairs a chunk of launch G (csrc/rankmf.cu kChunk)
CHUNK = 16384


class _Feats:
    """A padded feature table as ``rankmf._Feats`` holds it."""

    def __init__(self, idx, mask):
        self.idx, self.mask = idx, mask


def _launch_a_keys(ids, flag, S, feats, rowmap, es):
    """Launch A's keys of one table: the rank of update (s, l) of entity
    kind e (the e-th of ``es``) is (e-index) S F + s F + l."""
    F = 1 if feats is None else feats.idx.shape[1]
    keys = torch.full((len(es) * S * F,), -1, dtype=torch.int64)
    for k, e in enumerate(es):
        for s in range(S):
            if not flag[s, e]:
                continue
            for l in range(F):
                if feats is None:
                    f = int(ids[s, e])
                elif feats.mask[ids[s, e], l]:
                    f = int(feats.idx[ids[s, e], l])
                else:
                    continue
                if rowmap is not None:
                    f = int(rowmap[f])
                keys[k * S * F + s * F + l] = f
    return keys, F


def _radix_chunk(keys):
    """Launch G on one chunk: the stable LSD radix sort of (row, rank),
    8 bits a pass over the bits of the largest row + 1; -1 is the
    sentinel 2^32 - 1.  Returns (sorted rows, ranks, run starts, passes)."""
    k = [0xFFFFFFFF if int(v) < 0 else int(v) for v in keys]
    rank = list(range(len(k)))
    valid = [v for v in k if v != 0xFFFFFFFF]
    bits = (max(valid, default=0) + 1).bit_length()
    passes = 0
    for shift in range(0, bits, 8):
        digit = [(v >> shift) & 255 for v in k]
        order = sorted(range(len(k)), key=lambda i: digit[i])  # stable
        k = [k[i] for i in order]
        rank = [rank[i] for i in order]
        passes += 1
    starts = [i for i in range(len(k)) if k[i] != 0xFFFFFFFF
              and (i == 0 or k[i - 1] != k[i])]
    return k, rank, starts, passes


def _device_order(keys, chunk=CHUNK):
    """Launches G and W on one table's keys: {row: [update ranks in the
    order W walks them]}, and the radix passes of each chunk."""
    chunks = [keys[c:c + chunk] for c in range(0, len(keys), chunk)]
    sorted_ = [_radix_chunk(c) for c in chunks]
    walked, passes = {}, []
    for c, (k, rank, starts, p) in enumerate(sorted_):
        passes.append(p)
        for a, start in enumerate(starts):
            end = starts[a + 1] if a + 1 < len(starts) else sum(
                v != 0xFFFFFFFF for v in k)
            f = k[start]
            # walked by its first chunk's run
            if any(f in sorted_[c2][0] for c2 in range(c)):
                continue
            assert f not in walked
            seq = [c * chunk + rank[t] for t in range(start, end)]
            for c2 in range(c + 1, len(sorted_)):
                k2, r2 = sorted_[c2][0], sorted_[c2][1]
                lo = int(np.searchsorted(np.array(k2, dtype=np.uint64), f))
                while lo < len(k2) and k2[lo] == f:
                    seq.append(c2 * chunk + r2[lo])
                    lo += 1
            walked[f] = seq
    return walked, passes


def _entity(p, S, F, es):
    """The staged entity q = 3 s + e and slot l of update rank p."""
    k, rest = divmod(p, S * F)
    s, l = divmod(rest, F)
    return 3 * s + es[k], l


def _oracle(ids, flag, S, Fmax, feats, rowmap, es):
    """_walk_pairs: {row: [codes q Fmax + l in its stable order]}."""
    iscr = torch.cat([ids.reshape(-1), flag.reshape(-1).to(torch.int32)])
    k, codes = rankmf._walk_pairs(iscr.to(torch.int32), S, Fmax, feats,
                                  rowmap, es)
    out = {}
    for key, code in zip(k.tolist(), codes.tolist()):
        if key >= 0:
            out.setdefault(key, []).append(code)
    return out


def _case(seed, S, n_ent, n_rows, F=None, hot=None, p_flag=0.8):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, n_ent, (S, 3)).astype(np.int32))
    if hot is not None:                  # one entity in many samples
        ids[::hot[1], hot[0]] = 3
    flag = torch.from_numpy(rng.random((S, 3)) < p_flag)
    feats = None
    if F is not None:
        idx = torch.from_numpy(rng.integers(0, n_rows, (n_ent, F))
                               .astype(np.int32))
        mask = torch.from_numpy(rng.random((n_ent, F)) < 0.7)
        feats = _Feats(idx, mask)
    return ids, flag, feats


def _hold(ids, flag, S, feats, rowmap, es, Fmax, chunk=CHUNK):
    keys, F = _launch_a_keys(ids, flag, S, feats, rowmap, es)
    walked, passes = _device_order(keys, chunk)
    got = {f: [(lambda q, l: q * Fmax + l)(*_entity(p, S, F, es))
               for p in seq] for f, seq in walked.items()}
    assert got == _oracle(ids, flag, S, Fmax, feats, rowmap, es)
    return keys, walked, passes


@pytest.mark.parametrize("rowmap", [False, True])
@pytest.mark.parametrize("features", [False, True])
@pytest.mark.parametrize("table", ["W", "H"])
def test_device_order_is_walk_pairs(table, features, rowmap):
    S, n_ent, n_rows = 600, 900, 700
    ids, flag, feats = _case(7 + features + 2 * rowmap, S, n_ent, n_rows,
                             F=3 if features else None)
    es = (0,) if table == "W" else (1, 2)
    n_tab = n_rows if features else n_ent
    rmap = None
    if rowmap:                           # compact rows, as a mesh batch
        rng = np.random.default_rng(3)
        rmap = torch.from_numpy(rng.permutation(n_tab).astype(np.int32))
    keys, walked, passes = _hold(ids, flag, S, feats, rmap, es, Fmax=3)
    assert int((keys < 0).sum()) > 0     # -1 keys were written and skipped
    assert sum(map(len, walked.values())) == int((keys >= 0).sum())
    # only the bits the largest row needs: 10 bits, 2 passes
    assert passes == [2]


def test_all_keys_minus_one():
    """No acceptable negative anywhere: every key -1, no run, nothing
    walked."""
    ids, flag, _ = _case(1, 200, 50, 50, p_flag=0.0)
    keys, walked, passes = _hold(ids, flag, 200, None, None, (1, 2), 1)
    assert bool((keys == -1).all()) and walked == {} and passes == [1]


@pytest.mark.parametrize("table", ["W", "H"])
def test_hot_row_over_32_updates(table):
    """One row updated by over 32 samples: one run, walked in update
    order (H: its positives before its negatives)."""
    es = (0,) if table == "W" else (1, 2)
    ids, flag, _ = _case(5, 400, 300, 300, hot=(es[-1], 5), p_flag=1.0)
    if table == "H":
        ids[::7, 1] = 3
    _, walked, _ = _hold(ids, flag, 400, None, None, es, 1)
    seq = walked[3]
    assert len(seq) > 32 and seq == sorted(seq)


@pytest.mark.parametrize("features", [False, True])
def test_several_chunks(features):
    """A table of several chunks (chunk shrunk to 64 pairs): each row is
    walked once, by its run in its first chunk, with its later chunks'
    runs after it in order."""
    ids, flag, feats = _case(9, 300, 40, 30, F=2 if features else None,
                             hot=(2, 3), p_flag=0.9)
    keys, walked, passes = _hold(ids, flag, 300, feats, None, (1, 2), 2,
                                 chunk=64)
    assert len(passes) == -(-keys.numel() // 64) > 4
    spans = [len({p // 64 for p in seq}) for seq in walked.values()]
    assert max(spans) > 1


def test_keys_of_a_real_batch():
    """The entities of a BPR batch on ML-100k, decoded as K9 decodes them
    (user, positive, first acceptable negative; a sample without one
    updates nothing): both tables' device order is the oracle's."""
    csr = sp.csr_matrix(rt.load_movielens100k())
    csr.sort_indices()
    pos = rankmf._stage_positives(csr, "cpu")
    S, K = 256, 10
    n_item = csr.shape[1]
    bits = torch.from_numpy(np.random.default_rng(2).integers(
        0, 1 << 32, (S, K + 2), dtype=np.int64))
    u, valid, i, j_cand = rankmf._decode(bits, pos, n_item)
    acceptable = ~rankmf._in_hash_set(pos.table, pos.boff, pos.bmask,
                                      pos.bshift, u, j_cand)
    found, first_k, _ = rankmf._first_acceptable(acceptable, valid)
    j = j_cand.gather(1, first_k[:, None])[:, 0]
    ids = torch.stack([u, i, j], 1).to(torch.int32)
    flag = torch.stack([found] * 3, 1)
    _hold(ids, flag, S, None, None, (0,), 1)
    _hold(ids, flag, S, None, None, (1, 2), 1)
