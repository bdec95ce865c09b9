"""Port parity of FTRL (K7's plain version) and the GLM block staging.

The same numpy-made CSRs, labels and weights go through ``rsparse_tpu`` and
``rsparse_tpu_torch`` at float64 on the CPU, where the port's wrapper runs
K7's plain PyTorch version.  Stated tolerances: block updates, whole fits,
dropout with the reference's own keep mask and carried-over models to
1e-10 absolute; the per-sample replica of the reference loop
(src/FTRL.cpp:104-169) to 1e-12, as the reference's own test holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu.models import ftrl as ref_ftrl
from rsparse_tpu.ops.segsum import staged_label_gathers as ref_labels
from rsparse_tpu_torch.convert import ftrl_from_numpy
from rsparse_tpu_torch.models import ftrl as port_ftrl
from rsparse_tpu_torch.ops import segsum

torch.set_num_threads(2)

TOL = 1e-10


def glm_problem(seed=0, n_rows=150, n_feat=60, max_nnz=40, empty=(3, 77)):
    """Rows of 0 to ``max_nnz`` distinct features (several bucket lengths,
    so several blocks), N(0, 1) values, 0/1 labels with signal, weights in
    [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n_rows):
        k = 0 if i in empty else int(rng.integers(1, max_nnz + 1))
        rows += [i] * k
        cols += list(rng.choice(n_feat, size=k, replace=False))
        vals += list(rng.standard_normal(k))
    x = sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_feat))
    beta = rng.standard_normal(n_feat)
    y = (x @ beta + 0.3 * rng.standard_normal(n_rows) > 0).astype(float)
    w = rng.uniform(0.5, 1.5, n_rows)
    return x, y, w


def ref_blocks(x, y, w, zero_pad_weight=False):
    br, layouts = ref_ftrl._staged_blocks(x, jnp.float64, x.shape[1], None)
    labels = ref_labels("t_y", x, y, w, br, jnp.float64, None,
                        zero_pad_weight=zero_pad_weight)
    return br, layouts, labels


def port_blocks(x, y, w, zero_pad_weight=False):
    blocks = segsum.staged_glm_blocks(x, torch.float64, "cpu")
    labels = segsum.staged_label_gathers("t_y", x, y, w, blocks,
                                         torch.float64, "cpu",
                                         zero_pad_weight)
    return blocks, labels


@pytest.mark.parametrize("max_nnz", [6, 40])
def test_blocks_equal_the_reference_blocks(max_nnz):
    """Same rows, same order, same (B, L), same labels; the slot map
    indexes the block's distinct features."""
    x, y, w = glm_problem(seed=max_nnz, max_nnz=max_nnz)
    br, _, rlab = ref_blocks(x, y, w, zero_pad_weight=True)
    blocks, plab = port_blocks(x, y, w, zero_pad_weight=True)
    assert len(blocks) == len(br.buckets)
    assert (len(blocks) == 1) == (max_nnz <= 8)
    for rb, pb, (ry, rw), (py, pw) in zip(br.buckets, blocks, rlab, plab):
        for name in ("row_ids", "col_idx", "values", "nnz"):
            np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                          np.asarray(getattr(rb, name)))
        np.testing.assert_array_equal(py.numpy(), np.asarray(ry))
        np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
        m = pb.mask().numpy()
        feats, slot = pb.feats.numpy(), pb.slot.numpy()
        assert (np.diff(feats) > 0).all()
        np.testing.assert_array_equal(feats[slot[m]], pb.col_idx.numpy()[m])
        assert (slot[~m] == len(feats)).all()


FAMILIES = ["binomial", "gaussian", "poisson"]
REGS = {"l1": (0.3, 1.0), "elastic": (0.4, 0.6)}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reg", sorted(REGS))
@pytest.mark.parametrize("family", FAMILIES)
def test_ftrl_block_matches_reference(family, reg, weighted):
    """Every block of a pass, in order, from the same state: z, n and the
    predictions, update and predict modes."""
    x, y, w = glm_problem(seed=1)
    if family == "gaussian":
        y = y * 2.0 - 0.5
    elif family == "poisson":
        y = y * 3.0
        x = x * 0.2
    if not weighted:
        w = np.ones_like(w)
    lam, l1r = REGS[reg]
    lr, decay = 0.2, 0.7
    l1, l2 = lam * l1r, lam * (1 - l1r)
    fam = ref_ftrl._FAMILY_CODES[family]
    br, layouts, rlab = ref_blocks(x, y, w)
    blocks, plab = port_blocks(x, y, w)
    rng = np.random.default_rng(2)
    z0 = rng.standard_normal(x.shape[1] + 1) * 0.5
    n0 = rng.uniform(0.0, 2.0, x.shape[1] + 1)
    zj, nj = jnp.asarray(z0), jnp.asarray(n0)
    zt, nt = torch.tensor(z0), torch.tensor(n0)
    key = jax.random.PRNGKey(0)
    for k, (rb, lay, (ry, rw), pb, (py, pw)) in enumerate(
            zip(br.buckets, layouts, rlab, blocks, plab)):
        for do_update in (False, True):
            zj, nj, yj = ref_ftrl._ftrl_block(
                zj, nj, rb.col_idx, rb.values, ry, rw, key, lr, decay, l1, l2,
                0.0, lay, family=fam, do_update=do_update, use_dropout=False,
                rowmajor_pred=bool(k % 2))
            yt = port_ftrl._ftrl_block(zt, nt, pb, py, pw, lr, decay, l1, l2,
                                       0.0, None, fam, do_update)
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                       atol=TOL)
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0,
                                   atol=TOL)


def test_ftrl_block_dropout_with_reference_mask():
    """Dropout at function level: JAX's own keep draw handed to the port."""
    x, y, w = glm_problem(seed=3)
    dropout, lr, decay, l1, l2 = 0.35, 0.15, 0.5, 0.1, 0.05
    br, layouts, rlab = ref_blocks(x, y, w)
    blocks, plab = port_blocks(x, y, w)
    zj = jnp.zeros(x.shape[1] + 1)
    nj = jnp.zeros(x.shape[1] + 1)
    zt, nt = torch.zeros(x.shape[1] + 1, dtype=torch.float64), \
        torch.zeros(x.shape[1] + 1, dtype=torch.float64)
    for k, (rb, lay, (ry, rw), pb, (py, pw)) in enumerate(
            zip(br.buckets, layouts, rlab, blocks, plab)):
        key = jax.random.PRNGKey(10 + k)
        keep = jax.random.uniform(key, rb.values.shape) > dropout
        zj, nj, yj = ref_ftrl._ftrl_block(
            zj, nj, rb.col_idx, rb.values, ry, rw, key, lr, decay, l1, l2,
            dropout, lay, family=1, do_update=True, use_dropout=True,
            rowmajor_pred=False)
        yt = port_ftrl._ftrl_block(zt, nt, pb, py, pw, lr, decay, l1, l2,
                                   dropout, torch.from_numpy(np.array(keep)),
                                   1, True)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=TOL)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=TOL)


def test_ftrl_model_dropout_draws_from_its_generator():
    """At model level the keep masks come from the model's generator, one
    (B, L) draw per block: replaying the draws reproduces the fit, and the
    keep share is within 3 sigma of 1 - dropout."""
    x, y, w = glm_problem(seed=4, n_rows=400)
    p = 0.3
    m = rt.FTRL(learning_rate=0.1, lambda_=0.2, dropout=p, precision="double",
                seed=7, device="cpu")
    state = m._gen.get_state()
    m.partial_fit(x, y, w)
    g = torch.Generator()
    g.set_state(state)
    blocks, plab = port_blocks(x, y, w)
    z = torch.zeros(x.shape[1] + 1, dtype=torch.float64)
    n = torch.zeros_like(z)
    kept = total = 0
    for pb, (py, pw) in zip(blocks, plab):
        keep = torch.rand(pb.values.shape, generator=g) > p
        port_ftrl._ftrl_block(z, n, pb, py, pw, 0.1, 0.5, 0.2, 0.0, p, keep,
                              1, True)
        mk = pb.mask()
        kept += int(keep[mk].sum())
        total += int(mk.sum())
    assert torch.equal(g.get_state(), m._gen.get_state())
    np.testing.assert_allclose(m.z.numpy(), z.numpy(), rtol=0, atol=1e-15)
    share, sigma = kept / total, np.sqrt(p * (1 - p) / total)
    assert abs(share - (1 - p)) < 3 * sigma, (share, sigma)


def _ftrl_replica(X, y, wts, lr, decay, lam, l1r):
    """Reference src/FTRL.cpp:104-169 per-row loop, binomial, dropout=0
    (tests/test_sgd_replica.py)."""
    l1, l2 = lam * l1r, lam * (1 - l1r)
    F = X.shape[1]
    z = np.zeros(F)
    n = np.zeros(F)
    y_hat = np.zeros(X.shape[0])
    for i in range(X.shape[0]):
        p1, p2 = X.indptr[i], X.indptr[i + 1]
        idx, xv = X.indices[p1:p2], X.data[p1:p2]
        ww = np.where(
            np.abs(z[idx]) > l1,
            -(z[idx] - np.sign(z[idx]) * l1)
            / ((decay + np.sqrt(n[idx])) / lr + l2), 0.0)
        raw = np.sum(ww * xv)
        y_hat[i] = 1.0 / (1.0 + np.exp(-raw))
        d = wts[i] * (y_hat[i] - y[i])
        g = np.clip(d * xv, -1000.0, 1000.0)
        n_new = n[idx] + g * g
        sigma = (np.sqrt(n_new) - np.sqrt(n[idx])) / lr
        z[idx] += g - sigma * ww
        n[idx] = n_new
    return z, n, y_hat


def test_ftrl_per_sample_matches_reference_replica():
    x, y, w = glm_problem(seed=5, n_rows=30, n_feat=25, max_nnz=6, empty=())
    lr, decay, lam, l1r = 0.2, 0.7, 0.4, 0.6
    m = rt.FTRL(learning_rate=lr, learning_rate_decay=decay, lambda_=lam,
                l1_ratio=l1r, precision="double", seed=0, device="cpu")
    got = [float(m.partial_fit(x[i], [y[i]], [w[i]])[0])
           for i in range(x.shape[0])]
    z, n, y_hat = _ftrl_replica(x, y, w, lr, decay, lam, l1r)
    np.testing.assert_allclose(got, y_hat, rtol=0, atol=1e-12)
    np.testing.assert_allclose(m.z.numpy()[:x.shape[1]], z, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(m.n.numpy()[:x.shape[1]], n, rtol=0,
                               atol=1e-12)


@pytest.fixture(scope="module")
def fitted_pair():
    x, y, w = glm_problem(seed=6, n_rows=300)
    kw = dict(learning_rate=0.15, learning_rate_decay=0.6, lambda_=2.0,
              l1_ratio=0.7, precision="double")
    mj = rt_ref.FTRL(**kw)
    pj = mj.fit(x, y, w, n_iter=3)
    mt = rt.FTRL(**kw, device="cpu")
    pt = mt.fit(x, y, w, n_iter=3)
    return x, y, w, kw, mj, pj, mt, pt


def test_ftrl_fit_matches_reference(fitted_pair):
    x, _, _, _, mj, pj, mt, pt = fitted_pair
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL)
    np.testing.assert_allclose(mt.z.numpy(), np.asarray(mj.z), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(mt.n.numpy(), np.asarray(mj.n), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(mt.coef(), mj.coef(), rtol=0, atol=TOL)
    assert (mt.coef() == 0).any() and (mt.coef() != 0).any()   # l1 active
    np.testing.assert_allclose(mt.predict(x[::2]), mj.predict(x[::2]),
                               rtol=0, atol=TOL)


def test_ftrl_dump_load_and_carry_over(fitted_pair):
    """dump/load round trip; a reference model carried across by
    ``FTRL.load(ref.dump())`` and by ``ftrl_from_numpy`` takes the same next
    partial_fit as the reference."""
    x, y, w, kw, mj, _, mt, _ = fitted_pair
    d = mt.dump()
    back = rt.FTRL.load(d, precision="double", device="cpu")
    np.testing.assert_array_equal(back.coef(), mt.coef())
    np.testing.assert_array_equal(back.predict(x), mt.predict(x))
    x2, y2, w2 = glm_problem(seed=8, n_rows=120)
    carried = [rt.FTRL.load(mj.dump(), precision="double", device="cpu"),
               ftrl_from_numpy(np.asarray(mj.z), np.asarray(mj.n),
                               **kw, device="cpu")]
    pj = mj.partial_fit(x2, y2, w2)
    for mc in carried:
        pc = mc.partial_fit(x2, y2, w2)
        np.testing.assert_allclose(pc, pj, rtol=0, atol=TOL)
        np.testing.assert_allclose(mc.z.numpy(), np.asarray(mj.z), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(mc.n.numpy(), np.asarray(mj.n), rtol=0,
                                   atol=TOL)


def test_ftrl_errors_and_options():
    x, y, _ = glm_problem(seed=9, n_rows=20)
    m = rt.FTRL(device="cpu")
    with pytest.raises(RuntimeError):
        m.predict(x)
    with pytest.raises(ValueError):
        m.partial_fit(x, y[:5])
    m.partial_fit(x, y)
    with pytest.raises(ValueError):
        m.partial_fit(sp.random(20, 7, density=0.3, format="csr"), y)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        rt.FTRL(mesh=object(), device="cpu")
    assert rt.FTRL().device.type == "cuda"


def test_reference_quality():
    """``chip_smoke.REF_GLM_ACC["ftrl"]``, the train accuracy that
    chip_smoke.py phase 7 (b) holds the port to on the card, is the
    reference's (float32) on the same problem and hyperparameters."""
    import chip_smoke
    x, truth = chip_smoke.synth_glm()
    m = rt_ref.FTRL(learning_rate=0.1, lambda_=1.0, seed=0)
    m.fit(x, truth, n_iter=3)
    acc = float(((np.asarray(m.predict(x)) > 0.5) == truth).mean())
    assert abs(acc - chip_smoke.REF_GLM_ACC["ftrl"]) < 5e-6, acc
