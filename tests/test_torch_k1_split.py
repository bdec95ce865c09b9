"""K1's decomposition (``csrc/als_cg.cu``) replayed in plain torch on the
CPU.

K1 solves a bucket a tile of ``rows`` target rows at a time, a cluster of
``cluster`` CTAs sharing one tile (``ops/als.py`` ``cg_split``).  A row's
cold entries are dealt in chunks of 32 to the 16 / rows warps of each CTA
of the cluster, round robin; the dense head is cut into panels of 64
columns, dealt round robin to the cluster's CTAs, and each CTA counts the
tile's present cells in its panels: none skips the panel, fewer than
``tau`` walks its cells as entries, more makes it a tile product of 16
rows on the tensor cores (T = P Vh', weighted by the cells, then T_w Vh;
the rhs term is the second product alone, the loss term reads T; the
first pass sums the rhs less A x0 in one walk).  Each CTA sums its slice
of every pass, the warps' slices in order, then the
tile products, then the dense terms (P XtX, lam_use p or rhs_init) where
it owns the columns (P XtX a tile product too); the cluster's slices
meet in rank order.
:func:`_replay` does that at the input's dtype, and is held at float64 to
the plain version and to the JAX package's ``_solve_bucket_implicit`` /
``_solve_bucket_explicit`` (1e-10), implicit and explicit, with biases (d
= 129), a global bias, a uint8 head and presence bits, over splits that
make every panel kind and cluster size occur.

The tensor cores' operand rule is emulated as in
``tests/test_torch_k2_split.py``: 3xTF32 (hi hi + hi lo + lo hi, each
operand rounded to tf32 to nearest, ties away) at float32 compute, bf16
products exactly under ``compute_dtype="bfloat16"``, every sum float32.
Run in float32 with the rule, the replay stays within K1's limits of the
float32 plain version: y 1e-4 and loss 1e-5, or (bf16 cells that round
apart) y no further from the float64 twin than twice the plain version
in the Frobenius norm.

Last, the host split: every bucket shape of the ML-20M-shaped grid gets a
launch the card takes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsparse_tpu.ops import als as ref
from rsparse_tpu_torch.ops import als as port
from rsparse_tpu_torch.ops.topk import _expand_bits
from rsparse_tpu_torch.sparse.device import RowBucket

torch.set_num_threads(2)

PANEL, TILE, WARPS = port.CG_PANEL, port.CG_TILE, port.CG_WARPS


# -- the operand rule ---------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> tf32 (cvt.rna.tf32.f32), kept in float32."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -8192).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, rule) -> torch.Tensor:
    """a @ b as the tensor cores take it: exactly at a's dtype (no rule),
    3xTF32 ("tf32") or exact bf16 products ("bf16"), float32 sums."""
    if rule is None:
        return a @ b
    a, b = a.float(), b.float()
    if rule == "bf16":
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bl + al @ bh + ah @ bh


# -- the replay -----------------------------------------------------------------

def _rbf(t, on: bool):
    return t.to(torch.bfloat16).to(t.dtype) if on else t


def _replay(args, plan, *, hot_scale=None, rounding=False, rule=None):
    """K1 on one bucket as the kernel decomposes it, at the dtype of the
    source table (or float32 with ``rule``).  ``plan``: (rows, cluster,
    tau).  Returns (y (B, d), loss (B,))."""
    (src, xbias, XtX, rhs_init, b, x0, lam, g, cfg, W, Vh, bits,
     nnz_total) = args
    rows, cs, tau = plan
    explicit = cfg.feedback == "explicit"
    dt = src.dtype
    rb = lambda t: _rbf(t, rounding)  # noqa: E731
    B, L = b.col_idx.shape
    d = src.shape[1]
    wpr = WARPS // rows
    tiles = -(-B // rows)
    nnz = b.nnz.long()
    live = torch.arange(L)[None, :] < nnz[:, None]
    col = b.col_idx.long()
    X = rb(src[col])                                     # (B, L, d)
    c = torch.where(live, b.values.to(dt), torch.zeros((), dtype=dt))
    xb = (xbias.to(dt)[col] if (xbias is not None and cfg.with_biases)
          else torch.zeros_like(c))
    if explicit:
        g_rhs = g_loss = 0.0
    else:
        g_rhs = g if (cfg.with_biases or cfg.use_global_bias) else 0.0
        g_loss = g if cfg.use_global_bias else 0.0
    # which CTA of the cluster (rank) and which of its row's warps (slot)
    # walks each entry: chunk l // 32, dealt round robin
    unit = (torch.arange(L) // 32) % (cs * wpr)
    e_rank, e_slot = unit // wpr, unit % wpr

    # the head: cell values, presence, and each (tile, panel)'s kind
    H = 0 if W is None else W.shape[1]
    if H:
        Wc = W.to(dt)
        if hot_scale is not None:
            sc = rb(hot_scale.to(dt)) if rounding else hot_scale.to(dt)
            Wc = rb(Wc * sc[:, None]) if rounding else Wc * sc[:, None]
        if rounding and not explicit:
            Wc = rb(Wc)
        pres = (_expand_bits(bits)[:, :H] if (explicit and bits is not None)
                else Wc != 0)
        npan = -(-H // PANEL)
        pp = torch.nn.functional.pad(pres, (0, npan * PANEL - H,
                                            0, tiles * rows - B))
        cnt = pp.reshape(tiles, rows, npan, PANEL).sum((1, 3))
        tile_of = torch.arange(B) // rows
        dense = (cnt >= tau)[tile_of]                    # (B, npan)
        sparse = ((cnt > 0) & (cnt < tau))[tile_of]
        Vhd = rb(Vh.to(dt))

    def rhs_w(cv, xbv, head):
        if explicit:
            return rb(cv - xbv)
        if not rounding:
            return cv - (cv - 1.0) * (xbv + g_rhs)
        if head:
            return rb(cv - rb(rb(cv - 1.0) * rb(torch.tensor(g_rhs,
                                                               dtype=dt))))
        return rb(cv - (cv - 1.0) * (xbv + g_rhs))

    def coef(cv, dot, head):
        # with rounding the kernel forms a matvec coefficient from a float64
        # dot, as the float64 twin does (the products are exact)
        if rounding:
            dot = dot.double()
            cv = cv.double()
        if explicit:
            out = rb(dot)
        elif rounding and head:
            out = rb(rb(dot) * rb(cv - 1.0))
        else:
            out = rb(dot * (cv - 1.0)) if rounding else (cv - 1.0) * dot
        return out.to(dt)

    def entry_loss(cv, xbv, pred):
        if explicit:
            return (cv - xbv - pred) ** 2
        return cv * (1.0 - g_loss - xbv - pred) ** 2

    zero = torch.zeros((), dtype=dt)

    def weight(mode, cv, xbv, dots, head):
        """A term's weight: mode 0 rw, mode 1 -coef, mode 3 rw - coef (the
        rhs less A x0 in one walk), mode 2 the loss term."""
        if mode == 2:
            return entry_loss(cv, xbv, dots)
        w = rhs_w(cv, xbv, head) if mode != 1 else zero
        return w - coef(cv, dots, head) if mode != 0 else w

    def pass_sum(mode, vec, vdot):
        """One pass: (B, d) sums for mode 0 (rhs), 1 (A vec) and 3 (rhs - A
        vec), (B,) for mode 2 (the loss of y = vec)."""
        dots = None
        if mode != 0:
            xd = (X.double(), vdot.double()) if (rounding and mode != 2) \
                else (X, vdot)
            dots = torch.einsum("bld,bd->bl", *xd)
        w = torch.where(live, weight(mode, c, xb, dots, False), zero)
        ranks = []
        for q in range(cs):
            # the rank's warps' cold slices, in order
            part = 0
            for j in range(wpr):
                m = (e_rank == q) & (e_slot == j)
                wm = torch.where(m[None, :], w, zero)
                part = part + (wm.sum(1) if mode == 2
                               else torch.einsum("bl,bld->bd", wm, X))
            if H:
                owned = (torch.arange(npan) % cs) == q
                cells = pres & (sparse & owned[None])[:, torch.arange(H)
                                                      // PANEL]
                hd = None
                if mode != 0:
                    hd = ((Vhd.double() @ vdot.double().T).T
                          if (rounding and mode != 2) else (Vhd @ vdot.T).T)
                hw = torch.where(cells, weight(mode, Wc, zero, hd, True),
                                 zero)
                part = part + (hw.sum(1) if mode == 2 else hw @ Vhd)
                for p in range(npan):      # the tile products, in order
                    if p % cs != q:
                        continue
                    sl = slice(p * PANEL, min(H, (p + 1) * PANEL))
                    on = dense[:, p][:, None] & pres[:, sl]
                    Vp = Vhd[sl]
                    T = None if mode == 0 else _mm(vdot, Vp.T, rule).to(dt)
                    tw = torch.where(on, weight(mode, Wc[:, sl], zero, T,
                                                True), zero)
                    # rw - coef is not exact in bf16: the kernel takes the
                    # tf32 route for it
                    r2 = "tf32" if (mode == 3 and rule == "bf16") else rule
                    part = part + (tw.sum(1) if mode == 2
                                   else _mm(tw, Vp, r2).to(dt))
            # the dense terms, by the owner of each 8-column block
            if mode != 2:
                own = ((torch.arange(d) // 8) % cs == q).to(dt)
                if mode != 0:
                    part = part - own * (
                        lam_use[:, None] * vec if explicit
                        else _mm(vec, XtX.to(dt), rule).to(dt))
                if mode != 1 and rhs_init is not None:
                    part = part + own * rhs_init.to(dt)
            ranks.append(part)
        total = ranks[0]
        for part in ranks[1:]:
            total = total + part
        return -total if mode == 1 else total

    n_tot = (nnz_total if nnz_total is not None else b.nnz).to(dt)
    lam_use = (lam * n_tot if (explicit and cfg.dynamic_lambda)
               else torch.full((B,), lam, dtype=dt))
    x = x0.to(dt).clone()
    r = pass_sum(3, x, rb(x))
    p = r.clone()
    rsold = (r * r).sum(1)
    for _ in range(cfg.cg_steps):
        Ap = pass_sum(1, p, rb(p))
        live_r = rsold >= port.CG_TOL
        pAp = (p * Ap).sum(1)
        alpha = torch.where(live_r, rsold / torch.where(pAp == 0, 1.0, pAp),
                            torch.zeros((), dtype=dt))
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rsnew = (r * r).sum(1)
        beta = torch.where(live_r, rsnew / torch.where(rsold == 0, 1.0,
                                                       rsold),
                           torch.zeros((), dtype=dt))
        p = r + beta[:, None] * p
        rsold = torch.where(live_r, rsnew, rsold)
    loss = pass_sum(2, x, rb(x)) + lam_use * (x * x).sum(1)
    return x, loss


# -- cases ------------------------------------------------------------------------

N_SRC, B_ROWS, L_PAD, H_HEAD = 300, 21, 80, 150


def _case(seed, d, *, explicit=False, biases=False, ugb=False, head=None,
          bits=False, dynamic=True):
    """Numpy-made float64 inputs: a bucket of B_ROWS rows padded to L_PAD
    cold entries (rows of 0 to L_PAD entries), and a dense head of H_HEAD
    columns whose first panel is dense, second about a tenth present and
    third empty (explicit: ratings -2..2 with stored zeros and presence
    bits)."""
    rng = np.random.default_rng(seed)
    n_src = N_SRC
    V = rng.standard_normal((n_src, d)) * 0.3
    xb = rng.standard_normal(n_src) * 0.1 if biases else None
    nnz = rng.integers(0, L_PAD + 1, B_ROWS)
    nnz[:2] = (L_PAD, 0)
    col = np.zeros((B_ROWS, L_PAD), np.int32)
    val = np.zeros((B_ROWS, L_PAD))
    for i, n in enumerate(nnz):
        col[i, :n] = rng.choice(n_src, n, replace=False)
        val[i, :n] = (rng.integers(-2, 3, n) if explicit
                      else 1.0 + rng.exponential(3.0, n))
    W = Vh = hb = None
    if head is not None:
        dens = np.concatenate([np.full(64, 0.8), np.full(64, 0.1),
                               np.zeros(H_HEAD - 128)])
        present = rng.random((B_ROWS, H_HEAD)) < dens[None]
        Vh = rng.standard_normal((H_HEAD, d)) * 0.3
        if explicit:
            w = rng.integers(-2, 3, (B_ROWS, H_HEAD)).astype(np.float64)
            hb = np.packbits(present, axis=1, bitorder="little") if bits \
                else None
            if hb is None:
                w = np.where(w == 0, 1.0, w)
        else:
            w = 1.0 + rng.exponential(3.0, (B_ROWS, H_HEAD))
        W = w * present
    x0 = rng.standard_normal((B_ROWS, d)) * 0.05
    nnz_tot = None
    if explicit and head is not None:
        nnz_tot = (nnz + (W != 0 if hb is None else present).sum(1)).astype(
            np.int32)
    return dict(V=V, xb=xb, col=col, val=val, nnz=nnz.astype(np.int32),
                W=W, Vh=Vh, bits=hb, x0=x0, nnz_tot=nnz_tot,
                explicit=explicit, biases=biases, ugb=ugb, head=head,
                dynamic=dynamic)


def _quantise(W):
    wmax = W.max(1)
    s = np.where(wmax > 0, wmax / 255.0, 1.0)
    codes = np.where(W > 0, np.clip(np.rint(W / s[:, None]), 1, 255), 0)
    return codes.astype(np.uint8), s


LAM, G = 0.4, 0.06


def _port_args(cs, dt=torch.float64, compute="float32"):
    """(args for the plain version / replay, hot_scale) at dtype dt."""
    explicit = cs["explicit"]
    cfg = port.ALSConfig(
        solver=port.CONJUGATE_GRADIENT, cg_steps=3,
        feedback="explicit" if explicit else "implicit",
        with_biases=cs["biases"], use_global_bias=cs["ugb"],
        dynamic_lambda=explicit and cs["dynamic"], compute_dtype=compute)
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dt)
    V = t(cs["V"])
    if cs["biases"]:
        V = torch.cat([V, t(cs["xb"])[:, None]], 1)
    g = G if (cs["ugb"] or (cs["biases"] and not explicit)) else 0.0
    src_act, xb, XtX, rhs_init = port._sweep_prepare(V, LAM, g, cfg, dt)
    b = RowBucket(torch.arange(B_ROWS, dtype=torch.int32),
                  torch.from_numpy(cs["col"]), t(cs["val"]),
                  torch.from_numpy(cs["nnz"]))
    W, scale = cs["W"], None
    if cs["head"] == "uint8":
        W, scale = _quantise(W)
        W, scale = torch.from_numpy(W), t(scale)
    else:
        W = t(W)
    bits = None if cs["bits"] is None else torch.from_numpy(cs["bits"])
    nt = None if cs["nnz_tot"] is None else torch.from_numpy(cs["nnz_tot"])
    args = (src_act, xb, XtX, rhs_init, b, t(cs["x0"]), LAM, g, cfg, W,
            t(cs["Vh"]), bits, nt)
    return args, scale


def _jax(cs):
    """The JAX package's bucket solve on the same inputs (float64)."""
    from rsparse_tpu.sparse.device import RowBucket as RB
    explicit = cs["explicit"]
    cfg = ref.ALSConfig(
        feedback="explicit" if explicit else "implicit",
        solver=ref.CONJUGATE_GRADIENT, cg_steps=3,
        use_global_bias=cs["ugb"], with_biases=cs["biases"],
        dynamic_lambda=explicit and cs["dynamic"])
    V = jnp.asarray(cs["V"])
    if cs["biases"]:
        V = jnp.concatenate([V, jnp.asarray(cs["xb"])[:, None]], 1)
    g = G if (cs["ugb"] or (cs["biases"] and not explicit)) else 0.0
    src_act, xb, XtX, rhs_init = ref._sweep_prepare(
        V, jnp.asarray(LAM), jnp.asarray(g), cfg, jnp.float64)
    b = RB(jnp.arange(B_ROWS, dtype=jnp.int32), jnp.asarray(cs["col"]),
           jnp.asarray(cs["val"]), jnp.asarray(cs["nnz"]))
    W, scale = cs["W"], None
    if cs["head"] == "uint8":
        W, scale = _quantise(W)
        scale = jnp.asarray(scale)
    Wj = None if W is None else jnp.asarray(W)
    Vh = None if cs["Vh"] is None else jnp.asarray(cs["Vh"])
    x0 = jnp.asarray(cs["x0"])
    if explicit:
        return ref._solve_bucket_explicit(
            src_act, xb, b, x0, jnp.asarray(LAM), cfg, jnp.float64, hot_W=Wj,
            V_hot=Vh, hot_bits=None if cs["bits"] is None
            else jnp.asarray(cs["bits"]),
            nnz_total=None if cs["nnz_tot"] is None
            else jnp.asarray(cs["nnz_tot"]))
    return ref._solve_bucket_implicit(
        src_act, xb, XtX, rhs_init, b, x0, jnp.asarray(LAM), jnp.asarray(g),
        cfg, jnp.float64, hot_W=Wj, V_hot=Vh, hot_scale=scale)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


CASES = {
    "implicit head": dict(d=12, head="f32"),
    "implicit head, global bias": dict(d=12, head="f32", ugb=True),
    "implicit uint8 head": dict(d=12, head="uint8", ugb=True),
    "implicit biases d=129": dict(d=129, biases=True),
    "explicit bits": dict(d=12, explicit=True, head="f32", bits=True),
    "explicit head, static lambda": dict(d=12, explicit=True, head="f32",
                                         dynamic=False),
    "explicit biases d=129": dict(d=129, explicit=True, biases=True),
}
#: (rows, cluster, tau): whole tiles; a cluster of 4 over tiles of 4 rows
#: (4 warps a row, the panels dealt to 4 CTAs); one row over 16 CTAs; every
#: present panel a tile product (tau 1); every panel walked cell by cell
#: (tau above the 1,024 cells of a panel of 16 rows)
PLANS = [(16, 1, 32), (4, 4, 8), (1, 16, 33), (8, 2, 1), (16, 1, 1025)]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("plan", PLANS)
def test_replay_matches_plain_and_reference(name, plan):
    cs = _case(len(name) + 7 * plan[1], **CASES[name])
    args, scale = _port_args(cs)
    y, loss = _replay(args, plan, hot_scale=scale)
    yp, lp = port._solve_bucket_plain(*args, hot_scale=scale)
    yj, lj = _jax(cs)
    assert _rel(y, yp) <= 1e-10 and _rel(loss, lp) <= 1e-10
    assert _rel(y, yj) <= 1e-10 and _rel(loss, lj) <= 1e-10


def test_plans_make_every_panel_kind():
    """The cases' heads give tile products, walked panels and skipped
    panels under the plans above (so the replay exercises all three)."""
    cs = _case(1, 12, head="f32")
    args, _ = _port_args(cs)
    W = args[9]
    kinds = port.cg_head_panels(W, None, 16, 1, tau=32)
    assert kinds["dense_panels"] > 0 and kinds["sparse_panels"] > 0
    assert kinds["dense_panels"] + kinds["sparse_panels"] < kinds["panels"]
    walked = port.cg_head_panels(W, None, 16, 1, tau=1025)
    assert walked["dense_panels"] == 0 and walked["sparse_panels"] > 0
    tiled = port.cg_head_panels(W, None, 8, 2, tau=1)
    assert tiled["sparse_panels"] == 0 and tiled["dense_panels"] > 0


@pytest.mark.parametrize("name", ["implicit head", "implicit uint8 head",
                                  "explicit bits", "implicit biases d=129"])
@pytest.mark.parametrize("rounding", [False, True])
def test_operand_rule_holds_k1_limits(name, rounding):
    """float32 with the tensor cores' operand rule (3xTF32, or bf16 products
    under compute_dtype="bfloat16" with bf16 tables) against the float32
    plain version: y 1e-4, loss 1e-5; bf16 cells that round apart are held
    by the float64 twin (twice the plain version's Frobenius distance)."""
    cs = _case(len(name) + 3, **CASES[name])
    compute = "bfloat16" if rounding else "float32"
    args32, scale = _port_args(cs, torch.float32, compute)
    args64, scale64 = _port_args(cs, torch.float64, compute)
    if rounding:   # the bf16 shadow tables the kernel reads
        a = list(args32)
        a[0] = a[0].to(torch.bfloat16).float()
        if a[10] is not None:
            a[10] = a[10].to(torch.bfloat16).float()
        args32 = tuple(a)
    rule = "bf16" if rounding else "tf32"
    for plan in ((16, 1, 32), (2, 8, 8)):
        yk, lk = _replay(args32, plan, hot_scale=scale, rounding=rounding,
                         rule=rule)
        yp, lp = port._solve_bucket_plain(*args32, hot_scale=scale)
        y64, _ = port._solve_bucket_plain(*args64, hot_scale=scale64,
                                          rounding=rounding)
        ey = _rel(yk, yp)
        fro = lambda a: float(np.linalg.norm(  # noqa: E731
            np.asarray(a, np.float64) - y64.numpy()) / np.linalg.norm(
            y64.numpy()))
        assert np.isfinite(yk.numpy()).all()
        assert ey <= 1e-4 or (rounding and fro(yk) <= 2 * fro(yp)), (
            ey, fro(yk), fro(yp))
        # the loss of the kernel's own y, as chip_smoke.py holds it
        a = list(args32)
        a[5] = yk
        a[8] = dataclasses.replace(a[8], cg_steps=0)
        lown = port._solve_bucket_plain(*a, hot_scale=scale)[1]
        assert _rel(lk, lown) <= 1e-5


# -- the host split ----------------------------------------------------------------

#: the (rows, padded length) of every bucket of the ML-20M-shaped fit's
#: half-sweeps (chip_smoke.synth_ml20m_like, seed 0, rank 128, as phase 4
#: stages them): the f32 fit's item and user sweeps and the headline fit's
#: user sweep (its item sweep has the f32 fit's shapes)
ML20M_BUCKETS = [
    (200, 16), (2904, 24), (5848, 32), (4648, 40), (5520, 56), (3080, 72),
    (2632, 96), (1608, 120), (1336, 152), (1040, 192), (816, 240),
    (784, 320), (568, 416), (440, 544), (320, 704), (232, 896),
    (184, 1120), (144, 1408), (112, 1760), (88, 2208), (72, 2784),
    (64, 3488), (128, 33024), (72, 33024), (8, 41280),
    (6240, 8), (11272, 16), (10248, 24), (7912, 32), (5984, 40), (8416, 56),
    (5048, 72), (4304, 96), (2344, 120), (1608, 152), (976, 192), (560, 240),
    (416, 320), (160, 416), (72, 544), (16, 704), (16, 896), (8, 1120),
    (8, 1408),
    (10528, 8), (14544, 16), (10920, 24), (7576, 32), (5520, 40), (6744, 56),
    (3648, 72), (2832, 96), (1368, 120), (880, 152), (496, 192), (280, 240),
    (168, 320), (64, 416), (24, 544), (8, 896)]


@pytest.mark.parametrize("ctas_per_sm,max_cluster", [(1, 16), (2, 16),
                                                    (1, 8)])
def test_split_gives_every_ml20m_bucket_a_legal_launch(ctas_per_sm,
                                                       max_cluster):
    # the clusters of each size an H100's 132 SMs run at once
    active = {cs: 132 * ctas_per_sm // cs for cs in (1, 2, 4, 8, 16)
              if cs <= max_cluster}
    for B, L in ML20M_BUCKETS:
        rows, cl = port.cg_split(B, L, active)
        assert rows in (1, 2, 4, 8, 16) and cl in active, (B, L)
        assert cl == 1 or L >= port.CG_MIN_SLICE * (WARPS // rows) * cl
        # every entry of a row is walked by exactly one warp of one CTA
        unit = (np.arange(L) // 32) % (cl * (WARPS // rows))
        assert np.bincount(unit, minlength=cl * WARPS // rows).sum() == L
        for d, H, tb in ((128, 4096, 4), (128, 4096, 2), (129, 0, 4),
                         (128, 16384, 2)):
            assert port.cg_smem_bytes(d, H, tb, cl) <= port.SMEM_LIMIT
    # the longest rows take a CTA's warps or more each (8 rows of 41,280
    # over clusters), the short rows share CTAs
    assert port.cg_split(8, 41280, active)[1] > 1
    rows, cl = port.cg_split(128, 33024, active)
    assert WARPS // rows * cl >= WARPS
    assert port.cg_split(11272, 16, active) == (16, 1)


@pytest.mark.parametrize("units", [1, 2, 3, 8, 32, 512])
def test_walk_cost_is_the_busiest_warps_round_trips(units):
    """cg_split's walk cost: the most round trips (four entries loaded at
    once) any warp makes when a row's chunks of 32 are dealt round robin
    to ``units`` warps, counted here chunk by chunk."""
    for L in [1, 4, 5, 31, 32, 33, 64, 100, 1000, 4097, 33024, 41280]:
        trips = np.zeros(units, np.int64)
        for c in range(-(-L // 32)):
            trips[c % units] += -(-min(32, L - 32 * c) // 4)
        assert port._cg_walk(L, units) == trips.max(), (L, units)


@pytest.mark.parametrize("d,H,tbytes", [(10, 16, 4), (128, 4096, 4),
                                         (128, 16384, 2), (129, 4096, 4),
                                         (129, 0, 2)])
def test_one_cta_an_sm_fits_every_width(d, H, tbytes):
    """K1's shared memory at every width, head and table type the card
    meets, with and without a cluster's exchange buffers, within the 227 KB
    a CTA may use, with a cache of sparse head cells within its bounds."""
    for cluster in (1, 16):
        smem, cache = port.cg_layout(d, H, tbytes, cluster)
        assert smem <= port.SMEM_LIMIT
        assert cache == 0 if H == 0 else (
            port.CG_CACHE_MIN <= cache <= port.CG_CACHE_MAX
            and cache % 32 == 0)
