"""chip_smoke.py's pinned ML-100k quality of WRMF's reduced-precision
settings, held to the JAX package.

``chip_smoke.REF_LOWP`` pins the JAX package's NDCG@10 / MAP@10 at
``compute_dtype="bfloat16"``, ``hot_dtype="uint8"``, both, and
``precision="bfloat16"`` (bench.py:440's gate setup); the smoke run holds
the port on the card within ``LOWP_QUALITY_TOL`` of them.  Kept apart from
tests/test_torch_wrmf_lowp.py so that the four reference fits (~20 s on
the CPU) run beside it.
"""

import numpy as np

import chip_smoke
import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt


def test_chip_smoke_lowp_constants():
    """chip_smoke.REF_LOWP holds the JAX package's ML-100k NDCG@10 / MAP@10
    at each reduced-precision setting (bench.py:440's gate setup, 4
    digits), and the port's plain versions land within the smoke run's
    tolerance of them."""
    x = rt_ref.load_movielens100k()
    train, test = rt_ref.train_test_split(x, 0.2, np.random.default_rng(0))
    for what, (kw, (ndcg, mapk)) in chip_smoke.REF_LOWP.items():
        base = dict(rank=10, lambda_=1.0, feedback="implicit",
                    solver="conjugate_gradient", seed=0, **kw)
        for m in (rt_ref.WRMF(**base), rt.WRMF(device="cpu", **base)):
            m.fit_transform(train, n_iter=10)
            p = m.predict(train, k=10, not_recommend=train).indices
            got = (float(np.nanmean(rt_ref.ndcg_k(p, test))),
                   float(np.nanmean(rt_ref.ap_k(p, test))))
            tol = (5e-5 if isinstance(m, rt_ref.WRMF)
                   else chip_smoke.LOWP_QUALITY_TOL)
            assert abs(got[0] - ndcg) <= tol and abs(got[1] - mapk) <= tol, (
                what, type(m).__module__, got)
