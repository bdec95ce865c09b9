"""The parallel layer's host side, in this process: the ALX routing plans
and their wire-cost reports against the JAX package's on the same seeded
column ids, the bucket slices a rank keeps, ``process_row_range``,
``distributed_bucket_rows`` and a WRMF fit on a one-rank ``("dcn", "ici")``
mesh, the WRMF constructor's mesh checks, and the SGD models' ``mesh=``
(a port mesh taken, anything else refused)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

import rsparse_tpu as rt_ref
import rsparse_tpu_torch as rt
from rsparse_tpu.parallel import mesh as ref_mesh
from rsparse_tpu.parallel import multihost as ref_mh
from rsparse_tpu.parallel import routing as ref_routing
from rsparse_tpu.sparse.device import bucket_rows as ref_bucket_rows
from rsparse_tpu_torch.parallel import mesh as pmesh
from rsparse_tpu_torch.parallel import multihost, routing
from rsparse_tpu_torch.sparse.device import bucket_rows


def _col_ids(seed, n_dev, n_src):
    """Per-rank column ids with zipf-skewed references, ragged sizes."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / (np.arange(n_src) + 3.0)
    return [rng.choice(n_src, size=(int(rng.integers(5, 40)), 7),
                       p=pop / pop.sum()).astype(np.int32)
            for _ in range(n_dev)]


@pytest.mark.parametrize("n_dev,n_src", [(2, 96), (4, 96), (8, 256)])
def test_routing_plan_matches_reference(n_dev, n_src):
    """The padded plan: request ids, cache size, shard rows, remapped ids
    and the wire-cost report, equal to the JAX package's."""
    ids = _col_ids(n_dev, n_dev, n_src)
    plan, remap = routing.build_routing_plan(ids, n_src, n_dev)
    ref, ref_remap = ref_routing.build_routing_plan(ids, n_src, n_dev)
    np.testing.assert_array_equal(plan.request_ids,
                                  np.asarray(ref.request_ids))
    assert (plan.cache_size, plan.shard_rows) == (ref.cache_size,
                                                  ref.shard_rows)
    for a, b in zip(remap, ref_remap):
        np.testing.assert_array_equal(a, np.asarray(b))
    for rank, itemsize in ((8, 4), (128, 2)):
        assert routing.wire_cost_report(plan, n_dev, rank, itemsize) == \
            ref_routing.wire_cost_report(ref, n_dev, rank, itemsize)


@pytest.mark.parametrize("n_dev,n_src", [(2, 96), (4, 96), (8, 256)])
def test_ragged_routing_plan_matches_reference(n_dev, n_src):
    """The ragged plan's arrays, remapped ids and wire-cost report, equal
    to the JAX package's."""
    ids = _col_ids(10 + n_dev, n_dev, n_src)
    plan, remap = routing.build_ragged_routing_plan(ids, n_src, n_dev)
    ref, ref_remap = ref_routing.build_ragged_routing_plan(ids, n_src, n_dev)
    for f in ("want", "in_off", "send_sz", "out_off", "recv_sz"):
        np.testing.assert_array_equal(getattr(plan, f),
                                      np.asarray(getattr(ref, f)), f)
    assert (plan.cache_size, plan.shard_rows) == (ref.cache_size,
                                                  ref.shard_rows)
    for a, b in zip(remap, ref_remap):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert routing.wire_cost_report_ragged(plan, n_dev, 8) == \
        ref_routing.wire_cost_report_ragged(ref, n_dev, 8)


def test_routing_plans_need_a_dividing_table():
    ids = _col_ids(0, 3, 100)
    for build in (routing.build_routing_plan,
                  routing.build_ragged_routing_plan):
        with pytest.raises(ValueError, match="n_dev must divide n_src"):
            build(ids, 100, 3)


def _cpu_mesh(shape, names, coords):
    """A mesh description without process groups: enough for the slicing
    helpers, which read only the shape and this rank's coordinates."""
    return pmesh.Mesh(tuple(names), dict(zip(names, shape)),
                      dict(zip(names, coords)), torch.device("cpu"), "gloo",
                      {}, None)


def _implicit(seed=0, n_rows=300, n_cols=96):
    rs = np.random.RandomState(seed)
    x = sp.random(n_rows, n_cols, density=0.15, random_state=rs,
                  format="csr")
    x.data = 1.0 + 4.0 * x.data
    return x


@pytest.mark.parametrize("shape,coords", [((4, 2), (1, 0)),
                                          ((4, 2), (3, 1)),
                                          ((2, 1), (1, 0))])
def test_shard_buckets_keeps_the_reference_shard(shape, coords):
    """A rank keeps the rows of every bucket that the JAX package places on
    its device of a ``P("data")`` sharding: the same slice, array by
    array."""
    x = _implicit()
    n = shape[0]
    br = bucket_rows(x, torch.float64, "cpu", row_align=8 * n, max_buckets=4)
    mine = pmesh.shard_buckets(br, _cpu_mesh(shape, ("data", "model"),
                                             coords))
    ref = ref_mesh.shard_buckets(
        ref_bucket_rows(x, jnp.float64, row_align=8 * n, max_buckets=4),
        ref_mesh.make_mesh((n,), ("data",), jax.devices()[:n]))
    assert len(mine.buckets) == len(ref.buckets)
    for b, rb in zip(mine.buckets, ref.buckets):
        for t, rt_ in zip(b, rb):
            shard = next(s for s in rt_.addressable_shards
                         if s.index[0].start // (rt_.shape[0] // n)
                         == coords[0])
            np.testing.assert_array_equal(t.numpy(), np.asarray(shard.data))
    assert (mine.n_rows, mine.n_cols, mine.nnz) == (300, 96, x.nnz)


def test_slice_helpers():
    """``data_sharding`` keeps this rank's block of the leading axis (and
    refuses one that does not divide); ``replicated`` / ``replicate`` the
    whole array."""
    mesh = _cpu_mesh((2, 2), ("data", "model"), (1, 0))
    a = np.arange(24.0).reshape(8, 3)
    np.testing.assert_array_equal(pmesh.data_sharding(mesh, a).numpy(),
                                  a[4:])
    np.testing.assert_array_equal(
        pmesh.data_sharding(mesh, a, ("data", "model")).numpy(), a[4:6])
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.data_sharding(mesh, a[:7])
    for t in (pmesh.replicated(mesh, a), multihost.replicate(a, mesh)):
        np.testing.assert_array_equal(t.numpy(), a)
    assert multihost.data_spec(mesh) == "data"
    assert not multihost.is_multihost(mesh)


def test_shard_buckets_rejects_a_batch_that_does_not_divide():
    br = bucket_rows(_implicit(), torch.float64, "cpu", row_align=8)
    with pytest.raises(ValueError, match="not divisible by mesh axis 3"):
        pmesh.shard_buckets(br, _cpu_mesh((3,), ("data",), (0,)))


@pytest.mark.parametrize("n_rows,n_proc", [(943, 2), (943, 4), (10, 4),
                                           (3, 8)])
def test_process_row_range_matches_reference(n_rows, n_proc):
    for pid in range(n_proc):
        assert multihost.process_row_range(n_rows, n_proc, pid) == \
            ref_mh.process_row_range(n_rows, n_proc, pid)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A one-rank gloo process group in this process, torn down after the
    module."""
    store = tmp_path_factory.mktemp("store") / "f"
    multihost.initialize(f"file://{store}", 1, 0, device_type="cpu")
    yield multihost.make_multihost_mesh(device_type="cpu")
    dist.destroy_process_group()


def test_distributed_bucket_rows_one_rank_matches_reference(world1):
    """At one rank the negotiated buckets are the JAX package's at one
    process (its 8 virtual devices give the same row alignment): the same
    arrays, nnz and empty rows."""
    x = _implicit(1, 64, 48)
    x.data[x.indptr[7]:x.indptr[8]] = 0
    x.eliminate_zeros()
    br = multihost.distributed_bucket_rows(x, 0, 64, 48, world1,
                                           torch.float64, include_empty=True)
    ref = ref_mh.distributed_bucket_rows(x, 0, 64, 48,
                                         ref_mh.make_multihost_mesh(),
                                         jnp.float64, include_empty=True)
    assert (br.n_rows, br.n_cols, br.nnz) == (ref.n_rows, ref.n_cols,
                                              ref.nnz)
    np.testing.assert_array_equal(br.empty_rows, np.asarray(ref.empty_rows))
    assert len(br.buckets) == len(ref.buckets)
    for b, rb in zip(br.buckets, ref.buckets):
        for t, r in zip(b, rb):
            np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_wrmf_on_a_one_rank_multihost_mesh(world1):
    """WRMF on a one-rank ("dcn", "ici") mesh (per-rank bucket building,
    no zipf head) equals the one-process fit, and the mesh is recorded."""
    x = _implicit(2)
    kw = dict(rank=6, lambda_=0.5, solver="cholesky", precision="double",
              seed=0, device="cpu")
    m1 = rt.WRMF(n_hot=0, **kw)
    e1 = m1.fit_transform(x, n_iter=2, convergence_tol=-1)
    m2 = rt.WRMF(mesh=world1, **kw)
    e2 = m2.fit_transform(x, n_iter=2, convergence_tol=-1)
    assert m2.mesh is world1 and world1.axis_names == ("dcn", "ici")
    np.testing.assert_allclose(e2.numpy(), e1.numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(m2.loss_history, m1.loss_history, rtol=1e-12)


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(routing="alx"), ValueError, "requires a mesh"),
    (dict(routing="alx", mesh=("dcn",)), ValueError, "'data' axis"),
    (dict(routing="alx", mesh=("data",), with_user_item_bias=True),
     ValueError, "per-entity biases"),
    (dict(routing="alx_ragged", mesh=("dcn", "ici")), ValueError,
     "alx_ragged"),
    (dict(routing="alx2", mesh=("data",)), ValueError, "unknown routing"),
    (dict(mesh=("model",)), ValueError, "'data' axis"),
    (dict(mesh=object()), TypeError, "parallel.mesh.Mesh"),
])
def test_wrmf_rejects_what_cannot_run(kwargs, exc, match):
    """The constructor refuses meshes and routings that cannot run: the
    JAX package's checks (routing without a data axis, with biases), and
    ``alx_ragged`` on a ("dcn", "ici") mesh, which the JAX package only
    refuses at the first sweep."""
    names = kwargs.get("mesh")
    if isinstance(names, tuple):
        kwargs = dict(kwargs, mesh=_cpu_mesh((1,) * len(names), names,
                                             (0,) * len(names)))
    with pytest.raises(exc, match=match):
        rt.WRMF(device="cpu", **kwargs)


def test_reference_refuses_the_same_routings_late_or_early():
    """The JAX package refuses routing without a data axis and with biases
    in its constructor too."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("dcn",))
    with pytest.raises(ValueError, match="routing='alx'"):
        rt_ref.WRMF(mesh=mesh, routing="alx")
    mesh = ref_mesh.make_mesh((2,), ("data",), jax.devices()[:2])
    with pytest.raises(ValueError, match="per-entity biases"):
        rt_ref.WRMF(mesh=mesh, routing="alx", with_user_item_bias=True)


@pytest.mark.parametrize("make", [
    lambda mesh: rt.FTRL(mesh=mesh, device="cpu"),
    lambda mesh: rt.FactorizationMachine(mesh=mesh, device="cpu"),
    lambda mesh: rt.RankMF(mesh=mesh, device="cpu"),
    lambda mesh: rt.GloVe(rank=4, x_max=10, mesh=mesh, device="cpu"),
], ids=["ftrl", "fm", "rankmf", "glove"])
def test_sgd_models_still_refuse_a_mesh(make):
    """The SGD models take a port mesh (their tables row-sharded over its
    axes, parallel/sgd_sharded.py: here rank 1 of 2) and refuse anything
    else, as WRMF does."""
    mesh = _cpu_mesh((2,), ("data",), (1,))
    m = make(mesh)
    assert m.mesh is mesh and m.device == mesh.device
    assert (m._ops.axes, m._ops.index, m._ops.size) == (("data",), 1, 2)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        make(object())


def test_exports():
    assert rt.default_device_count() == (
        torch.cuda.device_count() if torch.cuda.is_available() else 1)
    assert rt.parallel.mesh.make_mesh is pmesh.make_mesh
    assert os.path.basename(rt.parallel.__file__) == "__init__.py"
