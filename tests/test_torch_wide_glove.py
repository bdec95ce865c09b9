"""Port parity of GloVe at the wide widths (K10's and K11's r <= 320 routes).

The card runs a rank on the narrowest instance of K10 and K11 that holds it
(``glove.GLOVE_WIDTHS``: 128 and 320, GloVe's published 300 dimensions
padded with zero columns).  On the CPU the wrappers run the kernels' plain
versions, which take any width; these tests hold them to the JAX package
at r = 300 on the same numpy-made inputs, and the width plan and caps as
pure functions.  Stated tolerances, as ``tests/test_torch_glove.py`` at the
same dtype: whole fits (head tiles and tail shards) at float64, 1e-10
absolute; the bf16 head (float32 state) against the reference run op by
op, each table's change relative to its largest change, 1e-5.
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
from rsparse_tpu_torch.convert import glove_from_numpy, glove_state_from_numpy
from rsparse_tpu_torch.models import glove as port_glove

torch.set_num_threads(2)

TOL = 1e-10
BF16_EAGER_REL = 1e-5
R = 300
HP = dict(x_max=10.0, alpha=0.75, lr=0.05)


def _cooc(n, density, seed, scale=3.0):
    m = sp.random(n, n, density=density, random_state=seed, format="coo")
    m.data = 1.0 + scale * m.data
    return m


@pytest.mark.parametrize("n_hot", [0, 64])
def test_wide_fit_matches_reference(n_hot):
    """fit_transform at rank 300 on a 600-token vocabulary, 2 epochs: the
    tail alone, and a 64-token head (K11's tiles) with the tail (K10's
    shards); float64."""
    x = _cooc(600, 0.02, 21)
    kw = dict(rank=R, x_max=10.0, learning_rate=0.05, batch_size=512,
              precision="double", seed=5, n_hot=n_hot)
    mj = rt_ref.GloVe(**kw)
    ej = np.asarray(mj.fit_transform(x, n_iter=2))
    mt = rt.GloVe(**kw, device="cpu")
    et = mt.fit_transform(x, n_iter=2)
    assert et.shape == (600, R)
    np.testing.assert_allclose(et.numpy(), ej, rtol=0, atol=TOL)
    np.testing.assert_allclose(mt.components, np.asarray(mj.components),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(mt.bias_j, np.asarray(mj.bias_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(mt.cost_history, mj.cost_history, rtol=0,
                               atol=TOL)


def test_wide_bf16_head_matches_reference():
    """float32 state at r = 300, bf16 head: one tile of 128 hot tokens
    against the reference's run op by op (both round at the points the
    reference's code names): each table's change to BF16_EAGER_REL."""
    n, H = 200, 128
    rng = np.random.default_rng(9)
    hot = np.sort(rng.choice(n, H, replace=False)).astype(np.int32)
    X = np.where(rng.random((H, H)) < 0.3,
                 1.0 + rng.exponential(8.0, (H, H)), 0.0).astype(np.float32)
    grids = ref_glove._head_grids(X, hot, jnp.bfloat16, 1 << 20)
    head = port_glove._stage_head(X, hot, torch.bfloat16, 1 << 20, "cpu")
    a = [rng.uniform(-0.1, 0.1, s) for s in ((n, R), (n, R), (n,), (n,))]
    a += [rng.uniform(1.0, 2.0, s) for s in ((n, R), (n, R), (n,), (n,))]
    a = [t.astype(np.float32) for t in a]
    sj0 = ref_glove.GloveState(*(jnp.asarray(t) for t in a))
    st = glove_state_from_numpy(a, "float32", "cpu")
    before = [t.clone() for t in st]
    with jax.disable_jit():
        sj, lj = ref_glove._glove_dense_step_impl(
            ref_glove._DIRECT, sj0, *grids, **HP, compute_dtype="bfloat16")
    lt = port_glove._glove_dense_step(st, head, **HP, cdt=torch.bfloat16)
    np.testing.assert_allclose(float(lt), float(lj), rtol=BF16_EAGER_REL)
    for name, p, j, t0 in zip(port_glove.GloveState._fields, st, sj, before):
        dp = p.double().numpy() - t0.double().numpy()
        dj = np.asarray(j, np.float64) - t0.double().numpy()
        rel = float(np.abs(dp - dj).max() / np.abs(dj).max())
        assert rel < BF16_EAGER_REL, (name, rel)


@pytest.mark.parametrize("r,width", [(1, 128), (128, 128), (129, 320),
                                     (300, 320), (320, 320)])
def test_width_plan(r, width):
    """K10 and K11 take a rank on the narrowest instance that holds it
    (the r <= 128 route keeps its instance)."""
    assert port_glove.glove_width(r) == width
    assert port_glove.GLOVE_WIDTHS == (128, 320)
    assert port_glove.MAX_RANK == 320


def test_above_the_cap_raises():
    """Above MAX_RANK the card raises NotImplementedError naming
    ROADMAP.md (checked before any tensor or kernel is touched); the CPU
    plain versions take any width."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_glove.glove_width(321)
    st = glove_state_from_numpy(
        [np.zeros((4, 321)), np.zeros((4, 321)), np.zeros(4), np.zeros(4),
         np.ones((4, 321)), np.ones((4, 321)), np.ones(4), np.ones(4)],
        "float32", "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_glove._check_state(st)


def test_convert_carries_wide_tables():
    """glove_state_from_numpy / glove_from_numpy at r = 300 carry the
    tables unchanged, and the converted model embeds as the JAX one."""
    rng = np.random.default_rng(4)
    n = 50
    a = [rng.standard_normal(s) for s in ((n, R), (n, R), (n,), (n,))]
    a += [rng.uniform(1.0, 2.0, s) for s in ((n, R), (n, R), (n,), (n,))]
    st = glove_state_from_numpy(a, "double", "cpu")
    for name, t, src in zip(port_glove.GloveState._fields, st, a):
        assert t.dtype == torch.float64 and t.shape == src.shape, name
        np.testing.assert_array_equal(t.numpy(), src, err_msg=name)
    m = glove_from_numpy(a[0], a[1], a[2], a[3], x_max=10.0,
                         precision="double", device="cpu")
    assert m.rank == R
    np.testing.assert_array_equal(m.components, a[1].T)
    np.testing.assert_array_equal(m.bias_i, a[2])
    np.testing.assert_array_equal(m.bias_j, a[3])

