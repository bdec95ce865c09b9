"""K3's one-pass route (``csrc/topk.cu`` topk_lists) emulated in plain torch
on the CPU.

For k <= ``TOPK_KMAX`` K3 reads each row once, split over ``parts`` CTAs of
``TOPK_THREADS`` threads (``rsparse_tpu_torch/ops/topk.py`` topk_plan).  A
CTA's columns are 16-byte chunks (after the row's unaligned head columns,
before its ragged tail); thread t of a CTA owns chunks c0 + t, c0 + t + T,
... .  Each thread first reads ``kSample`` of its chunks spread over its
range; the CTA's threshold tau is the k-th largest of its threads' maxima
of those samples.  A thread keeps its best
``list_k`` columns at or above tau; a warp takes the k best of its lanes'
lists, a CTA of its warps', and a row of its CTAs'.  :func:`_emulate` does
each of those steps with torch sorts, and the result is held bit for bit to
``_masked_top_k_plain`` (indices and values) on quarter-step scores, where
ties are everywhere.  Cases: all-masked rows, rows with fewer than k live
columns, no mask, rows whose first column is not 16-byte aligned (n not a
multiple of 4), a row split over 8 CTAs, k = 1, TOPK_KMAX and (the
round-based route) TOPK_KMAX + 1.
"""

import numpy as np
import pytest
import torch

from rsparse_tpu_torch.ops import topk

torch.set_num_threads(2)

K_SAMPLE = 4  # csrc/topk.cu kSample


def _best(v, i, k):
    """The k best (value desc, index asc) of the candidates (v, i)."""
    o = torch.argsort(i, stable=True)
    v, i = v[o], i[o]
    o = torch.argsort(v, descending=True, stable=True)
    return v[o][:k], i[o][:k]


def _emulate(scores, bits, k, glob_mean, plan, base=0):
    """topk_lists on (C, n) scores whose row r starts ``(base + r n) % 4``
    floats past a 16-byte boundary.  Returns (values, indices)."""
    C, n = scores.shape
    T, parts, K = topk.TOPK_THREADS, plan["parts"], plan["list_k"]
    live = torch.clamp(scores + glob_mean, min=topk.NEG_INF)
    if bits is not None:
        live = live.masked_fill(topk._expand_bits(bits), topk.NEG_INF)
    out_v = torch.empty((C, k), dtype=torch.float32)
    out_i = torch.empty((C, k), dtype=torch.int32)
    j = torch.arange(n)
    for row in range(C):
        lv = live[row]
        head = min(n, (4 - (base + row * n) % 4) % 4)
        nb = (n - head) // 4
        tail0 = head + 4 * nb
        chunk = torch.where((j >= head) & (j < tail0), (j - head) // 4, -1)
        cand_v, cand_i = [], []
        for rank in range(parts):
            c0, c1 = nb * rank // parts, nb * (rank + 1) // parts
            R = -(-(c1 - c0) // T)
            stride = max(1, R // K_SAMPLE)
            inside = (chunk >= c0) & (chunk < c1)
            tid = torch.where(inside, (chunk - c0) % T, -1)
            q = torch.where(inside, (chunk - c0) // T, -1)
            if rank == 0:
                tid = torch.where(j < head, j, tid)
            if rank == parts - 1:
                tid = torch.where(j >= tail0, j - tail0, tid)
            mine = tid >= 0
            sampled = inside & (q % stride == 0) & (q // stride < K_SAMPLE)
            lmax = torch.full((T,), -float("inf"))
            for t in range(T):
                sel = sampled & (tid == t)
                if sel.any():
                    lmax[t] = lv[sel].max()
            tau = float(torch.sort(lmax, descending=True).values[k - 1])
            keep = mine & (lv >= tau)
            warp_v, warp_i = [], []
            for wp in range(T // 32):
                lists_v, lists_i = [], []
                for t in range(32 * wp, 32 * wp + 32):
                    sel = keep & (tid == t)
                    v, i = _best(lv[sel], j[sel], K)
                    lists_v.append(v)
                    lists_i.append(i)
                v, i = _best(torch.cat(lists_v), torch.cat(lists_i), k)
                warp_v.append(v)
                warp_i.append(i)
            v, i = _best(torch.cat(warp_v), torch.cat(warp_i), k)
            cand_v.append(v)
            cand_i.append(i)
        v, i = _best(torch.cat(cand_v), torch.cat(cand_i), k)
        assert len(v) == k
        out_v[row], out_i[row] = v, i.to(torch.int32)
    return out_v, out_i


def _case(C, n, seed, masked):
    """Quarter-step scores (N(0, 16) rounded to 0.25: many exact ties);
    with ``masked``, 30% of the columns masked and, where C > 2, row 0 all
    masked, row 1 none, row 2 all but 5."""
    g = torch.Generator().manual_seed(seed)
    s = (torch.randn((C, n), generator=g) * 4).round() / 4
    if not masked:
        return s, None
    m = torch.rand((C, n), generator=g) < 0.3
    if C > 2:
        m[0] = True
        m[1] = False
        m[2] = True
        m[2, :5] = False
    bits = torch.from_numpy(np.packbits(m.numpy(), axis=1, bitorder="little"))
    return s, bits


@pytest.mark.parametrize("k", [1, 10, topk.TOPK_KMAX])
@pytest.mark.parametrize("C,n,masked,base", [
    (12, 1792, True, 0),      # a multiple of 256: the masked path
    (12, 1682, False, 0),     # ML-100k's items: n % 4 == 2
    (7, 1001, False, 3),      # every alignment of the row start
    (3, 256, True, 2),        # tiny rows, an unaligned start
    (1, 32768, True, 0),      # one row over 8 CTAs
])
def test_emulated_lists_route_is_the_plain_version(C, n, masked, base, k):
    s, bits = _case(C, n, C + n + k, masked)
    plan = topk.topk_plan(C, n, k, masked)
    assert plan["route"] == "lists"
    if C == 1:
        assert plan["parts"] == 8
    v, i = _emulate(s, bits, k, 0.25, plan, base)
    pv, pi = topk._masked_top_k_plain(s, bits, k, 0.25)
    assert torch.equal(i, pi)
    assert torch.equal(v, pv)
    if masked and C > 2:
        assert (v[0] == topk.NEG_INF).all()
        assert (v[2, 5:] == topk.NEG_INF).all()


def test_emulated_lists_route_with_parts():
    """Rows in 1 (the sample's stride 2 chunks), 2 and 4 CTAs."""
    s, bits = _case(4, 8192, 5, True)
    for parts in (1, 2, 4):
        plan = dict(topk.topk_plan(4, 8192, 10, True), parts=parts)
        v, i = _emulate(s, bits, 10, 0.0, plan)
        pv, pi = topk._masked_top_k_plain(s, bits, 10, 0.0)
        assert torch.equal(i, pi) and torch.equal(v, pv)


def test_sample_threshold_keeps_sorted_rows_exact():
    """Scores that rise (and fall) along the row, a thread's sample its
    chunks 0, 4, 8, 12 of 16: tau is still at most the k-th value."""
    s = torch.arange(16384, dtype=torch.float32)[None, :].repeat(2, 1) / 8
    s[1] = s[1].flip(0)
    plan = dict(topk.topk_plan(2, 16384, 10, False), parts=1)
    v, i = _emulate(s, None, 10, 0.0, plan)
    pv, pi = topk._masked_top_k_plain(s, None, 10, 0.0)
    assert torch.equal(i, pi) and torch.equal(v, pv)


def test_route_by_k_alignment_and_rows():
    p = topk.topk_plan(256, 32768, 10, True)
    assert (p["route"], p["list_k"], p["parts"], p["words"]) == (
        "lists", 16, 1, True)
    assert topk.topk_plan(256, 32768, 16, True)["list_k"] == 16
    assert topk.topk_plan(256, 32768, 17, True)["list_k"] == 32
    assert topk.topk_plan(256, 32768, topk.TOPK_KMAX, True)["route"] == "lists"
    p = topk.topk_plan(256, 32768, topk.TOPK_KMAX + 1, True)
    assert p["route"] == "rounds" and p["parts"] == 1
    assert topk.topk_plan(1, 32768, 10, True)["parts"] == 8
    assert topk.topk_plan(64, 32768, 10, True)["parts"] == 4
    assert topk.topk_plan(1, 1682, 10, False)["parts"] == 1
    # the mask as 32-bit words only where a row's bits are word aligned
    assert not topk.topk_plan(4, 1682, 10, False)["words"]
    assert not topk.topk_plan(4, 1688, 10, True)["words"]
    assert topk.topk_plan(4, 1792, 10, True)["words"]
    assert not topk.topk_plan(4, 1792, 10, False)["words"]


def test_round_route_past_kmax_on_cpu_is_the_plain_version():
    """k = TOPK_KMAX + 1 goes by rounds on the card; on CPU tensors the
    wrapper's answer is the plain version's, as for every k."""
    s, bits = _case(5, 1792, 3, True)
    k = topk.TOPK_KMAX + 1
    v, i = topk.masked_top_k_bits(s, bits, k, 0.5)
    pv, pi = topk._masked_top_k_plain(s, bits, k, 0.5)
    assert torch.equal(i, pi) and torch.equal(v, pv)
    for row in i.numpy():
        assert len(set(row.tolist())) == k
