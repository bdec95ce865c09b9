"""The port's host I/O, checkpoints and command line on the CPU:
``load_interactions`` against the JAX package's on the same files, the
native and numpy parsers against each other, the profiler trace, ML-100k
from the port's own copy, the port's own checkpoint round trip and WRMF's
resume, and ``fit`` -> ``recommend`` through the CLI.  (Checkpoints across
the packages and the CLI against the JAX package's CLI run in
tests/test_torch_checkpoint.py, beside the fits whose compiled programs
they share.  This file holds 21 tests, as that one does, for the reason
given there.)
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rsparse_tpu.data.io import load_interactions as load_jax
import rsparse_tpu_torch as rt
from rsparse_tpu_torch import checkpoint, native
from rsparse_tpu_torch.data.io import load_interactions as load_port

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: name -> (file text, load_interactions keyword arguments)
LOGS = {
    "int_ids_ratings_header": (
        "userId,movieId,rating\n7,100,3.5\n7,200,4.0\n9,100,1.0\n"
        "42,300,5.0\n", {}),
    "int_ids_no_ratings_no_header_tab": (
        "1\t5\n2\t6\n10\t5\n", dict(sep="\t", skip_header=False)),
    "string_ids_header": (
        "user,item,value\nalice,apple,2\nbob,banana,1\nalice,banana,3\n",
        {}),
    "string_ids_no_header": (
        "u1;i1\nu2;i1\nu1;i3\n", dict(sep=";", skip_header=False)),
    "int_ids_no_remap": (
        "u,i,r\n3,4,2.5\n0,1,1.0\n3,0,0.5\n", dict(remap_ids=False)),
    "duplicate_lines": (
        "u,i,r\n5,6,1.5\n5,6,2.0\n1,6,1.0\n5,6,0.25\n", {}),
}


@pytest.mark.parametrize("name", sorted(LOGS))
def test_load_interactions_matches_reference(tmp_path, name):
    """The same CSR (indptr, indices, float64 data, shape) and the same
    row / column names as the JAX package's loader."""
    text, kw = LOGS[name]
    path = tmp_path / "log.txt"
    path.write_text(text)
    ref, got = load_jax(str(path), **kw), load_port(str(path), **kw)
    assert got.shape == ref.shape
    for part in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, part), getattr(ref, part))
    assert got.data.dtype == np.float64
    assert got.row_names == ref.row_names
    assert got.col_names == ref.col_names
    assert got.parser == ("strings" if name.startswith("string") else
                          "native")


def test_string_ids_without_remap_raise(tmp_path):
    path = tmp_path / "log.csv"
    path.write_text("user,item\nalice,apple\n")
    for load in (load_jax, load_port):
        with pytest.raises(ValueError, match="remap_ids=True"):
            load(str(path), remap_ids=False)


def test_empty_log_raises(tmp_path):
    """A log with no interaction line (a header only) is an error in both
    packages."""
    path = tmp_path / "log.csv"
    path.write_text("user,item,rating\n")
    for load in (load_jax, load_port):
        with pytest.raises(ValueError, match="no interactions"):
            load(str(path))


BUFFERS = {
    "header_ratings": (b"u,i,r\n1,2,3.5\n4,5,1\n7,8,2.25\n", ",", True),
    "no_header_pairs": (b"1 2\n3 4\n5 6", " ", False),
    "bad_rating": (b"u,i,r\n1,2,1.5\n3,4,x\n5,6,7\n", ",", True),
    "string_lines_skipped": (b"1,2,1\nalice,bob,3\n4,5,2\n", ",", False),
}


@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_parse_routes_agree(monkeypatch, name):
    """The native OpenMP parser and the numpy fallback give the same
    arrays, dtypes included."""
    buf, sep, skip = BUFFERS[name]
    assert native.get_lib() is not None
    *fast, parser = native.parse_interactions_bytes(buf, sep, skip)
    assert parser == "native"
    monkeypatch.setattr(native, "get_lib", lambda: None)
    *slow, parser = native.parse_interactions_bytes(buf, sep, skip)
    assert parser == "numpy"
    for a, b in zip(fast, slow):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_ragged_lines_need_the_native_parser(monkeypatch):
    """A line without its rating reads 1 natively; the numpy route (the
    reference's ``genfromtxt``) needs as many fields on every line and
    raises rather than drop the line."""
    buf = b"u,i,r\n1,2\n3,4,2.5\n"
    users, items, ratings, _ = native.parse_interactions_bytes(buf)
    assert ratings.tolist() == [1.0, 2.5] and users.tolist() == [1, 3]
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(ValueError):
        native.parse_interactions_bytes(buf)


def test_trace_writes_a_file(tmp_path):
    """``trace`` records the block on the CPU into one Chrome trace file;
    with no directory it records nothing."""
    from rsparse_tpu_torch.utils.profiling import trace
    with trace(None) as t:
        pass
    assert t.path is None
    with trace(str(tmp_path / "prof"), cuda=False) as t:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.listdir(tmp_path / "prof") == [os.path.basename(t.path)]
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


_OPENED = None


def _record_opens(event, args):
    if _OPENED is not None and event == "open" and isinstance(args[0], str):
        _OPENED.append(os.path.abspath(args[0]))


def test_ml100k_reads_the_ports_copy():
    """Loading ML-100k in the port opens no file under rsparse_tpu/ (an
    audit hook records every file opened meanwhile)."""
    global _OPENED
    if not getattr(sys, "_rsparse_open_hook", False):
        sys.addaudithook(_record_opens)   # hooks last as long as the process
        sys._rsparse_open_hook = True
    _OPENED = []
    try:
        x = rt.load_movielens100k()
        opened = _OPENED
    finally:
        _OPENED = None
    assert x.shape == (943, 1682) and x.nnz == 100000
    ref = os.path.join(REPO, "rsparse_tpu") + os.sep
    assert not [p for p in opened if p.startswith(ref)], opened
    assert os.path.join(REPO, "rsparse_tpu_torch", "data",
                        "movielens100k.RData") in opened


def test_cli_fit_then_recommend(tmp_path):
    """``fit --out`` then ``recommend`` on the CPU: the JSON line's keys, a
    trace under --profile-dir, and ``recommend``'s lines equal to the
    loaded checkpoint's own ``predict`` (ids and printed scores)."""
    from rsparse_tpu_torch.cli import main
    out, prof = str(tmp_path / "ckpt"), str(tmp_path / "prof")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["fit", "--data", "movielens100k", "--rank", "4",
                     "--n-iter", "2", "--eval-holdout", "0.2", "--out", out,
                     "--profile-dir", prof, "--device", "cpu"]) == 0
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(res) == {"model", "rank", "fit_seconds", "ndcg@k", "map@k",
                        "checkpoint"}
    assert res["ndcg@k"] > 0.1 and res["checkpoint"] == out
    assert len(os.listdir(prof)) == 1
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["recommend", "--checkpoint", out, "--data",
                     "movielens100k", "-k", "5", "--limit", "3",
                     "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    x = rt.load_movielens100k()
    p = checkpoint.load(out, device="cpu").predict(x, k=5)
    assert len(lines) == 3
    for u, line in enumerate(lines):
        assert line["user"] == x.row_names[u]
        assert line["items"] == [str(i) for i in p.ids[u]]
        assert line["scores"] == [round(float(s), 4) for s in p.scores[u]]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device exists")
def test_cli_without_a_card_fails(monkeypatch, capsys):
    """``python -m rsparse_tpu_torch`` asks for the card by default and does
    not fall back to the CPU."""
    import runpy
    monkeypatch.setattr(sys, "argv", ["rsparse_tpu_torch", "fit", "--data",
                                      "movielens100k"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module("rsparse_tpu_torch", run_name="__main__")
    assert e.value.code == 2
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and err.out == ""


# -- the port's own checkpoints and WRMF's resume -------------------------------

def _implicit():
    rng = np.random.default_rng(0)
    x = sp.random(120, 90, density=0.08, random_state=1, format="csr")
    x.data = 1.0 + rng.exponential(2.0, x.nnz)
    return x


def test_port_checkpoint_round_trip(tmp_path):
    """The port reloads its own checkpoint with the attributes a fresh fit
    has: tensors on the device at the model's dtype, FTRL's pair table
    (written as the JAX package's ``z`` and ``n``), PureSVD's triple bit
    for bit, and none of the port's runtime state or telemetry."""
    x = _implicit()
    m = rt.WRMF(rank=4, lambda_=0.5, precision="bfloat16", seed=0,
                device="cpu")
    m.fit_transform(x, n_iter=2)
    checkpoint.save(m, str(tmp_path / "w"))
    with open(tmp_path / "w" / "meta.json") as f:
        meta = json.load(f)
    for name in ("device", "dtype", "stage_info", "fit_trace"):
        assert name not in meta
    assert meta["mesh"] is None and meta["routing"] is None
    assert set(meta["__bf16__"]) == {"_U", "_V", "components"}
    m2 = checkpoint.load(str(tmp_path / "w"), device="cpu")
    assert m2.dtype == torch.bfloat16 and m2._V.dtype == torch.bfloat16
    assert torch.equal(m2._V, m._V) and torch.equal(m2._U, m._U)
    assert m2.loss_history == m.loss_history

    f = rt.FTRL(learning_rate=0.1, lambda_=0.01, seed=0, device="cpu")
    f.partial_fit(x, (np.arange(x.shape[0]) % 2).astype(float))
    checkpoint.save(f, str(tmp_path / "f"))
    assert set(np.load(tmp_path / "f" / "arrays.npz").files) == {"z", "n"}
    f2 = checkpoint.load(str(tmp_path / "f"), device="cpu")
    assert f2.zn.shape == f.zn.shape and torch.equal(f2.zn, f.zn)

    p = rt.PureSVD(rank=4, seed=0, device="cpu")
    p.fit_transform(x, n_iter=3)
    checkpoint.save(p, str(tmp_path / "p"))
    p2 = checkpoint.load(str(tmp_path / "p"), device="cpu")
    for a, b in zip(p2._svd, p._svd):
        assert torch.equal(a, b)


def test_orbax_and_mesh_checkpoints_raise(tmp_path):
    """The orbax store (mesh-sharded tables) and models fitted on a mesh
    stay outside the port: saving to orbax raises, and so does loading a
    checkpoint whose meta.json says ``"__store__": "orbax"`` or names a
    mesh, as the JAX package's orbax and mesh saves write."""
    x = _implicit()
    f = rt.FTRL(learning_rate=0.1, seed=0, device="cpu")
    f.partial_fit(x, (np.arange(x.shape[0]) % 2).astype(float))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        checkpoint.save(f, str(tmp_path / "o"), store="orbax")
    for key, value in (("__store__", "orbax"), ("mesh", "Mesh('data': 4)")):
        path = tmp_path / key
        checkpoint.save(f, str(path))
        with open(path / "meta.json") as fh:
            meta = json.load(fh)
        meta[key] = value
        with open(path / "meta.json", "w") as fh:
            json.dump(meta, fh)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            checkpoint.load(str(path), device="cpu")


_RESUME_KW = dict(rank=6, lambda_=0.5, seed=0, with_global_bias=True,
                  n_hot=16, device="cpu")


def test_resume_is_bitwise_the_uninterrupted_fit(tmp_path):
    """A fit stopped after 2 of 4 iterations and resumed from its state ends
    on the uninterrupted fit's factors, loss history and embeddings, bit
    for bit (the CG sweeps with a dense head, then the exact transform)."""
    x = _implicit()
    full = rt.WRMF(**_RESUME_KW)
    e_full = full.fit_transform(x, n_iter=4, convergence_tol=-1)
    path = str(tmp_path / "state")
    part = rt.WRMF(**_RESUME_KW)
    part.fit_transform(x, n_iter=2, convergence_tol=-1,
                       checkpoint_path=path, checkpoint_every=1)
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["it"] == 2
    resumed = rt.WRMF(**_RESUME_KW)
    e_res = resumed.fit_transform(x, n_iter=4, convergence_tol=-1,
                                  checkpoint_path=path, resume=True)
    assert torch.equal(e_res, e_full)
    assert np.array_equal(resumed.components, full.components)
    assert resumed.loss_history == full.loss_history
    assert len(resumed.fit_trace.records) == 2 * 2 + 1


def test_resume_edges(tmp_path):
    """Nothing on disk: a fit from scratch; no checkpoint_path: an error;
    checkpoint_every=2 writes after iteration 2 and not after 3."""
    x = _implicit()
    full = rt.WRMF(**_RESUME_KW)
    e_full = full.fit_transform(x, n_iter=3, convergence_tol=-1)
    fresh = rt.WRMF(**_RESUME_KW)
    e_fresh = fresh.fit_transform(x, n_iter=3, convergence_tol=-1,
                                  checkpoint_path=str(tmp_path / "nope"),
                                  resume=True)
    assert torch.equal(e_fresh, e_full)
    with pytest.raises(ValueError, match="checkpoint_path"):
        rt.WRMF(**_RESUME_KW).fit_transform(x, n_iter=3, resume=True)
    path = str(tmp_path / "every2")
    rt.WRMF(**_RESUME_KW).fit_transform(
        x, n_iter=3, convergence_tol=-1, checkpoint_path=path,
        checkpoint_every=2)
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["it"] == 2
