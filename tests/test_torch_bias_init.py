"""Port parity: the alternating closed-form bias initialisation.

The same numpy CSR goes through ``rsparse_tpu.ops.bias_init`` and
``rsparse_tpu_torch.ops.bias_init`` (both numpy, float64): the global bias,
both bias vectors and the (possibly centred) matrix must be identical.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from rsparse_tpu.ops.bias_init import initialize_biases as ref_init
from rsparse_tpu_torch.ops.bias_init import initialize_biases as port_init


def _ratings(seed, explicit):
    rng = np.random.default_rng(seed)
    m = sp.random(60, 40, density=0.15,
                  random_state=np.random.RandomState(seed), format="lil")
    m[4, :] = 0                                    # an empty user
    m[:, 9] = 0                                    # an empty item
    m = sp.csr_matrix(m)
    m.data = (np.round(1.0 + 4.0 * m.data) if explicit
              else 1.0 + rng.exponential(2.0, m.nnz))
    return m


@pytest.mark.parametrize("explicit", [True, False])
@pytest.mark.parametrize("dynamic,non_negative,glob", [
    (True, False, True), (False, False, False), (True, True, False),
    (False, True, True)])
def test_initialize_biases_identical(explicit, dynamic, non_negative, glob):
    x = _ratings(3 + explicit, explicit)
    gj, uj, ij, cj = ref_init(x, 0.3, dynamic, non_negative, glob, explicit)
    gt, ut, it, ct = port_init(x, 0.3, dynamic, non_negative, glob, explicit)
    assert gt == gj
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(it, ij)
    for a in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(ct, a), getattr(cj, a))
    assert ut[4] == 0.0 and it[9] == 0.0 or not explicit
    if non_negative:
        assert ut.min() >= 0 and it.min() >= 0
    if explicit and glob:
        np.testing.assert_allclose(ct.data, x.data - x.data.mean())
