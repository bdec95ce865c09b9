"""Checkpoints shared between the port and the JAX package (models and a
WRMF fit state), and the port's CLI against the JAX package's (chip_smoke's
pinned ``REF_CLI``, the JSON lines, each other's checkpoints).  The port's
own round trip and resume are in tests/test_torch_io_cli.py.

Every model class goes through ``save`` in one package and ``load`` in the
other, both ways: the loaded model's ``predict`` gives the source model's
item ids, its ``components`` (or FTRL / FM's ``predict``, GloVe's
``components`` and biases) within 1e-6 of the source's, and its scores
within 1e-5 of the largest (2e-3 for bf16 tables: the two packages round
the transform's bf16 products in their own order).  The recommenders on
ML-100k are fitted at the settings of ``chip_smoke.CLI_FLAGS``, at which
the CLI tests run both CLIs: the JAX package compiles each model's programs
once for the whole file.  (The file holds 21 tests, as
tests/test_torch_io_cli.py does: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests, then by name, so both sit right after
tests/test_topk_metrics.py.  Its ~570 s test is its second-to-last, and the
worker that runs it takes the next file in the queue as that test starts;
with these two files queued ahead of tests/test_parallel.py (~330 s), that
worker seldom gets it.)
"""

import contextlib
import functools
import io
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import rsparse_tpu as rj
import rsparse_tpu_torch as rt
from rsparse_tpu.cli import main as jax_cli
from rsparse_tpu.utils import checkpoint as ck_jax
from rsparse_tpu_torch import checkpoint as ck_port

torch.set_num_threads(2)

N_ITER = int(chip_smoke.CLI_FLAGS[chip_smoke.CLI_FLAGS.index("--n-iter") + 1])
KW = dict(rank=10, lambda_=1.0, seed=0)


@functools.lru_cache(maxsize=None)
def _ml100k():
    x = rj.load_movielens100k()
    return rj.train_test_split(x, 0.2, np.random.default_rng(0))[0]


@functools.lru_cache(maxsize=None)
def _glm():
    rs = np.random.RandomState(0)
    x = sp.random(200, 50, density=0.2, random_state=rs, format="csr")
    return x, rs.randint(0, 2, 200).astype(float)


@functools.lru_cache(maxsize=None)
def _small_implicit():
    rng = np.random.default_rng(0)
    x = sp.random(120, 90, density=0.08, random_state=1, format="csr")
    x.data = 1.0 + rng.exponential(2.0, x.nnz)
    return x


def _fit(pkg, kind):
    """A model of ``kind`` fitted by ``pkg`` (rj or rt) and the matrix its
    ``predict`` is checked on (None: FTRL / FM / GloVe)."""
    dev = {} if pkg is rj else {"device": "cpu"}
    if kind in ("wrmf", "wrmf_bf16"):
        prec = "bfloat16" if kind == "wrmf_bf16" else "float32"
        m = pkg.WRMF(precision=prec, **KW, **dev)
        m.fit_transform(_ml100k(), n_iter=N_ITER)
        return m, _ml100k()
    if kind in ("puresvd", "linearflow"):
        cls = pkg.PureSVD if kind == "puresvd" else pkg.LinearFlow
        m = cls(**KW, **dev)
        m.fit_transform(_ml100k(), n_iter=N_ITER)
        return m, _ml100k()
    if kind == "rankmf":
        x = _small_implicit()
        m = pkg.RankMF(rank=4, learning_rate=0.1, seed=0, **dev)
        m.partial_fit_transform(x, n_iter=2)
        return m, x
    if kind == "glove":
        s = sp.csr_matrix(_small_implicit()).sign()
        m = pkg.GloVe(rank=4, x_max=10.0, learning_rate=0.05, seed=0, **dev)
        m.fit_transform((s.T @ s).tocoo(), n_iter=2)
        return m, None
    x, y = _glm()
    if kind == "ftrl":
        m = pkg.FTRL(learning_rate=0.1, lambda_=0.01, seed=0, **dev)
    else:
        m = pkg.FactorizationMachine(rank=4, seed=0, **dev)
    m.partial_fit(x, y)
    return m, None


@pytest.fixture(scope="module")
def fitted():
    """``fitted(package, kind)``: the model of ``_fit``, fitted once for the
    module ("jax" or "port")."""
    cache = {}

    def get(pkg_name, kind):
        if (pkg_name, kind) not in cache:
            cache[pkg_name, kind] = _fit(rj if pkg_name == "jax" else rt,
                                         kind)
        return cache[pkg_name, kind]
    return get


def _np(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                      np.float64)


def _check_same(kind, src, dst, q):
    """``dst`` (loaded in the other package) computes what ``src`` does."""
    if kind == "glove":
        for name in ("components", "bias_i", "bias_j"):
            np.testing.assert_allclose(_np(getattr(dst, name)),
                                       _np(getattr(src, name)), atol=1e-6)
        return
    if kind in ("ftrl", "fm"):
        x = _glm()[0]
        np.testing.assert_allclose(_np(dst.predict(x)), _np(src.predict(x)),
                                   atol=1e-6)
        return
    np.testing.assert_allclose(_np(dst.components), _np(src.components),
                               atol=1e-6)
    if kind == "puresvd" and isinstance(dst, rj.PureSVD):
        # the JAX package keeps PureSVD's fitted triple as a named tuple,
        # which its loader cannot rebuild (it writes its own as text), so
        # no PureSVD it loads can transform: components only
        with pytest.raises(AttributeError):
            dst.transform(q)
        return
    a = src.predict(q, k=10, not_recommend=q)
    b = dst.predict(q, k=10, not_recommend=q)
    np.testing.assert_array_equal(b.indices, a.indices)
    tol = 2e-3 if kind == "wrmf_bf16" else 1e-5
    sa = np.asarray(a.scores, np.float64)
    np.testing.assert_allclose(np.asarray(b.scores, np.float64), sa,
                               atol=tol * np.abs(sa).max())


KINDS = ("wrmf", "wrmf_bf16", "puresvd", "linearflow", "ftrl", "fm",
         "rankmf", "glove")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_across_packages(fitted, kind, direction, tmp_path):
    src_pkg = "jax" if direction == "jax_to_port" else "port"
    src, q = fitted(src_pkg, kind)
    path = str(tmp_path / kind)
    if src_pkg == "jax":
        ck_jax.save(src, path)
        dst = ck_port.load(path, device="cpu")
        assert type(dst) is getattr(rt, type(src).__name__)
        assert dst.device == torch.device("cpu")
    else:
        ck_port.save(src, path)
        dst = ck_jax.load(path)
        assert type(dst) is getattr(rj, type(src).__name__)
    _check_same(kind, src, dst, q)


def test_warm_start_from_a_jax_checkpoint(fitted, tmp_path):
    """A JAX checkpoint's components warm-start a port fit (the reference's
    ``init`` semantics, R/model_WRMF.R:245-249): the same as starting from
    the JAX model's own components, and the same on a second run."""
    src, x = fitted("jax", "wrmf")
    ck_jax.save(src, str(tmp_path / "w"))
    comps = ck_port.load(str(tmp_path / "w"), device="cpu").components
    runs = []
    for init in (comps, np.asarray(src.components), comps):
        m = rt.WRMF(init=init, **dict(KW, seed=1), device="cpu")
        runs.append((m.fit_transform(x, n_iter=1, convergence_tol=-1),
                     m.loss_history))
    for e, loss in runs[1:]:
        assert torch.equal(e, runs[0][0]) and loss == runs[0][1]


# -- a fit state across the packages -----------------------------------------

def test_port_resumes_a_jax_fit_state(tmp_path):
    """A fit state the JAX package wrote after 1 of 4 iterations, resumed by
    the port, lands within 1e-5 of the JAX package's uninterrupted fit
    (float64, where the two packages' sums agree to ~1e-12)."""
    x = _small_implicit()
    kw = dict(rank=6, lambda_=0.5, seed=0, precision="double")
    full = rj.WRMF(**kw)
    e_full = np.asarray(full.fit_transform(x, n_iter=4, convergence_tol=-1))
    path = str(tmp_path / "state")
    rj.WRMF(**kw).fit_transform(x, n_iter=1, convergence_tol=-1,
                                checkpoint_path=path)
    resumed = rt.WRMF(**kw, device="cpu")
    e_res = resumed.fit_transform(x, n_iter=4, convergence_tol=-1,
                                  checkpoint_path=path, resume=True)
    np.testing.assert_allclose(resumed.loss_history, full.loss_history,
                               rtol=1e-5)
    np.testing.assert_allclose(resumed.components, full.components,
                               atol=1e-5)
    np.testing.assert_allclose(e_res.numpy(), e_full, atol=1e-5)


# -- the two CLIs: chip_smoke's pinned quality, and each other's checkpoints --

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs' ``fit`` on ML-100k at chip_smoke.CLI_FLAGS for each model
    (the port's on the CPU): (package, model) -> (its JSON line, its
    checkpoint)."""
    from rsparse_tpu_torch.cli import main as port_cli
    root = tmp_path_factory.mktemp("cli")
    runs = {}
    for model in chip_smoke.REF_CLI:
        for pkg, main, extra in (("jax", jax_cli, []),
                                 ("port", port_cli, ["--device", "cpu"])):
            out = str(root / f"{pkg}_{model}")
            lines = _run(main, ["fit", "--data", "movielens100k", "--model",
                                model, *chip_smoke.CLI_FLAGS, "--out", out,
                                *extra])
            runs[pkg, model] = (json.loads(lines[-1]), out)
    return runs


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().strip().splitlines()


def test_chip_smoke_ref_cli(cli_runs):
    """chip_smoke.REF_CLI holds the JAX CLI's ML-100k ndcg@k / map@k at
    CLI_FLAGS (4 digits); the port's CLI on the CPU lands within the smoke
    run's tolerance of them."""
    for model, (ndcg, mapk) in chip_smoke.REF_CLI.items():
        for pkg, tol in (("jax", 5e-5),
                         ("port", chip_smoke.CLI_QUALITY_TOL[model])):
            res = cli_runs[pkg, model][0]
            assert abs(res["ndcg@k"] - ndcg) <= tol, (pkg, res)
            assert abs(res["map@k"] - mapk) <= tol, (pkg, res)


def test_cli_matches_the_jax_cli(cli_runs):
    """For each model: the same JSON keys, and ndcg@k / map@k within 1e-3."""
    for model in chip_smoke.REF_CLI:
        ref, _ = cli_runs["jax", model]
        got, _ = cli_runs["port", model]
        assert set(got) == set(ref)
        assert got["model"] == model and got["rank"] == ref["rank"]
        for key in ("ndcg@k", "map@k"):
            assert abs(got[key] - ref[key]) <= 1e-3, (key, got, ref)


def test_cli_reads_the_other_clis_checkpoint(cli_runs):
    """A WRMF checkpoint from either CLI: the other CLI's ``recommend``
    prints the writer's own lines (the same users and items; the scores,
    printed to 4 decimals, within one unit of the last digit: the two
    packages' float32 transforms differ by ~2e-6)."""
    from rsparse_tpu_torch.cli import main as port_cli
    for writer, reader in (("jax", "port"), ("port", "jax")):
        ckpt = cli_runs[writer, "wrmf"][1]
        argv = ["recommend", "--checkpoint", ckpt, "--data", "movielens100k",
                "--limit", "5"]
        lines = {"jax": _run(jax_cli, argv),
                 "port": _run(port_cli, argv + ["--device", "cpu"])}
        own, other = lines[writer], lines[reader]
        assert len(own) == len(other) == 5
        for a, b in zip(map(json.loads, own), map(json.loads, other)):
            assert (a["user"], a["items"]) == (b["user"], b["items"])
            np.testing.assert_allclose(b["scores"], a["scores"], atol=1.5e-4)
