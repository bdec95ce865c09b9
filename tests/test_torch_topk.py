"""Port parity: masked exact top-k and ``top_product``.

Inputs made with numpy go through ``rsparse_tpu.ops.topk`` and
``rsparse_tpu_torch.ops.topk`` (plain version of K3 on the CPU).  Stated
tolerances: identical indices, scores to 1e-6, at float32.  Integer-valued
embeddings make the scores exact in both frameworks, so ties are real ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rsparse_tpu.ops import topk as ref
from rsparse_tpu_torch.ops import topk as port

torch.set_num_threads(2)


def _check(ij, sj, it, st):
    np.testing.assert_array_equal(np.asarray(it), np.asarray(ij))
    np.testing.assert_allclose(np.asarray(st), np.asarray(sj), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("n,k,ties", [(1024, 9, False), (1024, 40, True),
                                      (512, 7, True)])
def test_masked_top_k_bits_matches_reference(n, k, ties):
    rng = np.random.default_rng(n + k)
    B = 12
    if ties:
        s = rng.integers(-3, 4, (B, n)).astype(np.float32)
    else:
        s = rng.standard_normal((B, n)).astype(np.float32)
    mask = rng.random((B, n)) < 0.4
    mask[0] = True                          # all masked
    mask[1] = False                         # nothing masked
    mask[2] = True
    mask[2, [5, 700 % n, 3]] = False        # fewer than k live columns
    bits = np.packbits(mask, axis=1, bitorder="little")
    sj, ij = ref.masked_top_k_bits(jnp.asarray(s), jnp.asarray(bits), k,
                                   glob_mean=0.25)
    st, it = port.masked_top_k_bits(torch.from_numpy(s),
                                    torch.from_numpy(bits), k, 0.25)
    _check(ij, sj, it, st)
    assert it.dtype == torch.int32
    for row in it.numpy():
        assert len(set(row.tolist())) == k
    assert (st[0] == port.NEG_INF).all()


def _int_factors(seed, n_users, n_items, r=6):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (n_users, r)).astype(np.float32)
    y = rng.integers(-2, 3, (r, n_items)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("case", ["unmasked", "masked", "exclude",
                                  "masked_exclude", "few_live", "k_max"])
def test_top_product_matches_reference(case):
    n_users, n_items, k = 300, 700, 10       # n_items not a multiple of 256
    x, y = _int_factors(len(case), n_users, n_items)
    nr = exclude = None
    if case in ("masked", "masked_exclude"):
        nr = sp.random(n_users, n_items, density=0.3,
                       random_state=np.random.RandomState(2), format="csr")
    if case in ("exclude", "masked_exclude"):
        exclude = np.arange(0, n_items, 7)
    if case == "few_live":
        dense = np.ones((n_users, n_items))
        dense[:, [4, 90, 650]] = 0
        dense[1] = 0                         # one row fully live
        nr = sp.csr_matrix(dense)
    if case == "k_max":
        k = n_items - 1
        exclude = np.asarray([123])
    ij, sj = ref.top_product(x, y, k, not_recommend=nr, exclude=exclude,
                             glob_mean=0.5)
    it, st = port.top_product(torch.from_numpy(x), y, k, not_recommend=nr,
                              exclude=exclude, glob_mean=0.5)
    _check(ij, sj, it, st)
    assert it.dtype == np.int32 and st.dtype == np.float32


def test_top_product_float_scores_and_tensor_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((70, 16)).astype(np.float32)
    y = rng.standard_normal((16, 333)).astype(np.float32)
    nr = sp.random(70, 333, density=0.1,
                   random_state=np.random.RandomState(4), format="csr")
    ij, sj = ref.top_product(x, y, 12, not_recommend=nr, user_chunk=32)
    it, st = port.top_product(torch.from_numpy(x), torch.from_numpy(y), 12,
                              not_recommend=nr, user_chunk=32)
    _check(ij, sj, it, st)


def test_pack_mask_bits_and_expand():
    rng = np.random.default_rng(5)
    dense = rng.random((5, 40)) < 0.5
    b = port.pack_mask_bits(48, dense_rows=dense)
    np.testing.assert_array_equal(b, ref.pack_mask_bits(48, dense_rows=dense))
    exp = port._expand_bits(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(exp[:, :40], dense)
    assert exp[:, 40:].all()
