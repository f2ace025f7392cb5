"""The port's sharded (M, P) plane against its unsharded engine and the
JAX reference's single-device engine.

One module fixture starts 8 gloo ranks once (``torch_sharded_worker.py``,
forked from one process after its imports, a ``file://`` rendezvous
under the test's temporary directory, each rank on one thread, killed
once no rank finishes a run for 120 s). They run every configuration of
the reference's sharded suite (``tests/test_sharded.py``'s ``_SCRIPT``:
DIM 12, 256 samples, M=16, 41 steps, Momentum lr 0.05 / mu 0.9, seed 3) —
the seven schedules, the outer optimizer, the indexed data plane, ring /
torus / gossip_pairs, bf16 / int8 / one_bit on periodic / stochastic /
adaptive_budget, the int8 ring mix — plus fault plans (crash, rejoin,
straggle 0.25, curriculum 1), telemetry and an elastic run that shrinks
the mesh from 8 ranks to 6 and back, each under both collectives, two
rows a rank. Then:

- ``gather`` is the unsharded port run bit for bit: params, history,
  every rank's rows;
- ``psum`` has the unsharded run's decisions and event steps, params,
  losses and dispersions within rtol 1e-5 / atol 1e-7 (the reference's
  own psum tolerances);
- both hold against ``repro``'s single-device engine, run here: ``gather``
  at the north star's tolerances, ``psum`` at the psum tolerances (loss
  traces by ``allclose``: R1); a lossy wire at ``WIRE_TOL`` (see there);
- every rank returns the same history and consensus, and computes the
  same telemetry accumulator; the ranks never import ``jax`` or
  ``repro``.

In-process cases hold ``sharding/specs.py``'s shape rules to the
reference's ``PartitionSpec`` outputs, the row-sliced fault transition to
the reference's bit for bit, and the mesh and engine refusals.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import torch_sharded_worker as tw  # noqa: E402
from repro import faults as jf  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch import faults as pf  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.core import AveragingSchedule, PhaseEngine  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.optim import Momentum  # noqa: E402
from repro_torch.sharding import specs as pspecs  # noqa: E402
from torch_parity import TOL, assert_runs_match  # noqa: E402

WORLD = 8
NAMES = list(tw.CONFIGS)
PSUM_TOL = dict(params=dict(rtol=1e-5, atol=1e-7),
                loss=dict(rtol=1e-5, atol=1e-7), disp=dict(rtol=1e-5))
#: a lossy wire against the reference: the port's unsharded run already
#: lands one quantum apart from it where a gradient differs in its last
#: bit (bf16-stochastic: one bf16 ulp of one row, 3.7e-4 of the mean), so
#: these configurations take ``test_torch_engine``'s one-bf16-ulp plane
#: and 1e-4 trace tolerances there
WIRE_TOL = dict(params=dict(rtol=2 ** -8, atol=1e-7),
                loss=dict(rtol=1e-4, atol=1e-7), disp=dict(rtol=1e-4))


def _ref_tol(name, tol):
    return WIRE_TOL if "wire" in tw.CONFIGS[name] else tol


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 8 ranks' results. The unsharded and reference runs are made
    here after the ranks end: the ranks' collectives wait on every rank,
    so they run without this process's threads competing for the CPU."""
    workdir = str(tmp_path_factory.mktemp("sharded"))
    out = tw.collect(tw.start(WORLD, workdir), workdir, WORLD)
    for name in NAMES:
        unsharded(name)
        reference(name)
    return out


@functools.lru_cache(maxsize=None)
def unsharded(name):
    res, state, _ = tw.port_run(name)
    res["plane"] = state.plane.numpy().copy()
    return res


@functools.lru_cache(maxsize=None)
def reference(name):
    """Configuration ``name`` on ``repro``'s single-device engine."""
    from types import SimpleNamespace

    from repro import elastic as je
    from repro.core import AveragingSchedule as JSched
    from repro.core import Compression as JComp
    from repro.core import OuterOptimizer as JOuter
    from repro.core import PhaseEngine as JEngine
    from repro.data.pipeline import DeviceDataset as JDataset
    from repro.optim import Momentum as JMomentum
    from repro.topology import Topology as JTopology

    X, y, idx = tw.problem()
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    ns = SimpleNamespace(AveragingSchedule=JSched, OuterOptimizer=JOuter,
                         Topology=JTopology, Compression=JComp,
                         FaultPlan=jf.FaultPlan)

    def loss_fn(p, b, r):
        res = b["x"] @ p["w"] - b["y"]
        return 0.5 * jnp.mean(res * res), {}

    cfg = tw.CONFIGS[name]
    eng = JEngine(loss_fn, JMomentum(lr=tw.LR, mu=tw.MU),
                  **tw.engine_kwargs(name, ns))
    params = {"w": jnp.zeros(tw.DIM)}
    kw = dict(seed=tw.SEED, record_every=1)
    if cfg.get("elastic"):
        plan = je.ElasticPlan(tw.WORKERS, tw.ELASTIC["resizes"],
                              tw.ELASTIC["curriculum"])

        def data(m, t0, k):
            return [{"x": Xj[idx[t, :m]], "y": yj[idx[t, :m]]}
                    for t in range(t0 - 1, t0 - 1 + k)]
        return je.run_elastic(eng, params, data, plan, steps=tw.STEPS, **kw)
    if cfg.get("indexed"):
        data = JDataset({"x": Xj, "y": yj}, tw.WORKERS, indices=idx)
    else:
        data = [{"x": Xj[idx[t]], "y": yj[idx[t]]} for t in range(tw.STEPS)]
    return eng.run(params, data, num_workers=tw.WORKERS, **kw)


def _decisions(h):
    return h["averages"], [t for t, _ in h["dispersion"]]


# ---- the ranks against the unsharded port -----------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_gather_is_the_unsharded_run_bitwise(ranks, name):
    base = unsharded(name)
    for res in ranks:
        got = res[(name, "gather")]
        np.testing.assert_array_equal(got["w"], base["w"])
        assert got["hist"] == base["hist"]
        if "rows" in got:
            r0, r1 = got["row_range"]
            np.testing.assert_array_equal(got["rows"], base["plane"][r0:r1])


@pytest.mark.parametrize("name", NAMES)
def test_psum_matches_the_unsharded_run(ranks, name):
    base = unsharded(name)
    got = ranks[0][(name, "psum")]
    assert _decisions(got["hist"]) == _decisions(base["hist"])
    assert got["hist"].get("resizes") == base["hist"].get("resizes")
    np.testing.assert_allclose(got["w"], base["w"], **PSUM_TOL["params"])
    for key, k in (("loss", "loss"), ("disp_trace", "disp"),
                   ("dispersion", "disp")):
        assert ([t for t, _ in got["hist"][key]]
                == [t for t, _ in base["hist"][key]])
        np.testing.assert_allclose([v for _, v in got["hist"][key]],
                                   [v for _, v in base["hist"][key]],
                                   **PSUM_TOL[k])


@pytest.mark.parametrize("coll", tw.COLLECTIVES)
@pytest.mark.parametrize("name", NAMES)
def test_every_rank_returns_the_same_run(ranks, name, coll):
    first = ranks[0][(name, coll)]
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[(name, coll)]["w"], first["w"])
        assert res[(name, coll)]["hist"] == first["hist"]


# ---- the ranks against the reference's single-device engine -----------------

@pytest.mark.parametrize("name", NAMES)
def test_gather_matches_the_reference(ranks, name):
    got = ranks[0][(name, "gather")]
    assert_runs_match(({"w": torch.from_numpy(got["w"])}, got["hist"]),
                      reference(name), _ref_tol(name, TOL))


@pytest.mark.parametrize("name", NAMES)
def test_psum_matches_the_reference(ranks, name):
    got = ranks[0][(name, "psum")]
    assert_runs_match(({"w": torch.from_numpy(got["w"])}, got["hist"]),
                      reference(name), _ref_tol(name, PSUM_TOL))


# ---- telemetry and imports --------------------------------------------------

@pytest.mark.parametrize("coll", tw.COLLECTIVES)
def test_telemetry_records_and_accumulators(ranks, coll):
    base = unsharded("telemetry")
    got = ranks[0][("telemetry", coll)]
    if coll == "gather":
        assert got["records"] == base["records"]
    else:
        assert ([(r["type"], r.get("step")) for r in got["records"]]
                == [(r["type"], r.get("step")) for r in base["records"]])
    for res in ranks[1:]:
        # only the world's rank 0 writes to its sink
        assert res[("telemetry", coll)]["records"] == []
        np.testing.assert_array_equal(res[("telemetry", coll)]["metrics"],
                                      got["metrics"])
    eng = PhaseEngine(tw.port_loss, Momentum(lr=tw.LR, mu=tw.MU),
                      device="cpu", **tw.engine_kwargs("telemetry",
                                                       tw.port_ns()))
    want = tw.phase_metrics(eng)
    if coll == "gather":
        np.testing.assert_array_equal(got["metrics"], want)
    else:
        np.testing.assert_allclose(got["metrics"], want, rtol=1e-5,
                                   atol=1e-7)


def test_ranks_import_no_jax(ranks):
    assert all(res["modules"] == [] for res in ranks)


# ---- specs: the reference's shape rules, case for case ----------------------

SHAPES = [(8, 12), (4, 6, 16), (3, 5), (16,), (2, 8, 8, 4), (7, 7, 2)]


def _same(port, ref):
    assert tuple(port) == tuple(ref)
    assert ref == JP(*port)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("msize", [1, 2, 4])
def test_leaf_and_first_divisible_specs(shape, msize):
    for prefix in ((), (("data",),), ("pod",)):
        if len(prefix) > len(shape) - 1:
            continue
        _same(pspecs.leaf_spec(shape, msize, prefix=prefix),
              jspecs.leaf_spec(shape, msize, prefix=prefix))
        _same(pspecs.first_divisible_spec(shape, msize, prefix=prefix),
              jspecs.first_divisible_spec(shape, msize, prefix=prefix))
    _same(pspecs.leaf_spec(shape, msize, prefer_axis=0),
          jspecs.leaf_spec(shape, msize, prefer_axis=0))


def _template(lib):
    z = (lambda s: np.zeros(s, np.float32)) if lib == "np" else \
        (lambda s: jax.ShapeDtypeStruct(s, jnp.float32))
    return {"embed": z((64, 16)), "blocks": [
        {"w_in": z((4, 16, 32)), "w_out": z((4, 32, 16)), "norm": z((16,))},
        {"attn": {"k": z((16, 8)), "v": z((16, 8))}}], "bias": z((3,))}


@pytest.mark.parametrize("msize", [2, 4, 8])
@pytest.mark.parametrize("moe", [False, True])
def test_tree_param_and_batch_specs(msize, moe):
    tp, tj = _template("np"), _template("jax")
    got = pspecs.param_specs(tp, msize, worker_axes=("data",),
                             moe_expert_parallel=moe)
    want = jspecs.param_specs(tj, msize, worker_axes=("data",),
                              moe_expert_parallel=moe)
    for g, w in zip(jax.tree.leaves(got, is_leaf=lambda x: isinstance(
            x, tuple)), jax.tree.leaves(want)):
        _same(g, w)
    got = pspecs.batch_specs(tp, msize, worker_axes="data")
    want = jspecs.batch_specs(tj, msize, worker_axes="data")
    for g, w in zip(jax.tree.leaves(got, is_leaf=lambda x: isinstance(
            x, tuple)), jax.tree.leaves(want)):
        _same(g, w)


@pytest.mark.parametrize("layout", ["seq", "heads"])
@pytest.mark.parametrize("batch", [1, 4])
def test_cache_specs(layout, batch):
    def cache(z):
        return [{"k": z((batch, 64, 4, 16)), "v": z((batch, 64, 4, 16)),
                 "pos": z(())}, {"h": z((batch, 32))}]
    jspecs.set_axis_sizes({"data": 2, "model": 2})
    pspecs.set_axis_sizes({"data": 2, "model": 2})
    want = jspecs.cache_specs(
        cache(lambda s: jax.ShapeDtypeStruct(s, jnp.float32)), 2,
        data_axes="data", long_layout=layout)
    got = pspecs.cache_specs(cache(lambda s: np.zeros(s, np.float32)), 2,
                             data_axes="data", long_layout=layout)
    flat = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
    for g, w in zip(flat, jax.tree.leaves(want)):
        _same(g, w)
    jspecs.set_axis_sizes({})
    pspecs.set_axis_sizes({})


def test_partition_spec_canonical_form():
    for parts in ((("data",),), ((),), (("pod", "data"), None, "model"),
                  (["a", "b"],), ()):
        _same(pspecs.P(*parts), JP(*parts))
    assert pspecs.P(("data",)) == ("data",)
    assert repr(pspecs.P("a", None)) == "PartitionSpec('a', None)"


def _world_mesh(shape, axes):
    return pmesh.WorkerMesh(tuple(axes), dict(zip(axes, shape)), 0,
                            (0,), None, "gloo", torch.device("cpu"))


def test_mesh_worker_axes_and_plane_sharding():
    assert pspecs.mesh_worker_axes(
        _world_mesh((1, 1), ("data", "model"))) == ("data",)
    assert pspecs.mesh_worker_axes(
        _world_mesh((1, 1, 1), ("pod", "data", "model"))) == ("pod", "data")
    mesh = _world_mesh((1, 1), ("data", "model"))
    assert pspecs.plane_sharding(mesh).spec == JP(("data",))
    assert pspecs.plane_sharding(mesh, axes=("model",)).spec == JP(("model",))
    assert pmesh.worker_axes(_world_mesh((1, 1, 1), ("pod", "data",
                                                     "model"))) == (
        "pod", "data")
    assert pmesh.worker_axes(_world_mesh((2, 1, 1), ("pod", "data", "model")),
                             hierarchical=True) == ("data",)
    assert pmesh.num_workers(_world_mesh((2, 3, 1),
                                         ("pod", "data", "model"))) == 6


def test_engine_state_sharding_tree():
    eng = PhaseEngine(tw.port_loss, Momentum(lr=0.1), device="cpu",
                      schedule=AveragingSchedule("periodic", 8),
                      compression=tw.port_ns().Compression("int8"),
                      faults=pf.FaultPlan.parse("crash:m=1@t=2", 4))
    state = eng.init({"w": torch.zeros(3)}, 4)
    sh = pspecs.engine_state_sharding(_world_mesh((1,), ("data",)), state)
    assert sh.plane.spec == JP(("data",))
    assert [s.spec for s in sh.opt_planes] == [JP(("data",))]
    assert sh.resid.spec == JP(("data",))
    assert sh.fault.alive.spec == sh.fault.staleness.spec == JP(("data",))
    assert sh.key.spec == sh.dec_key.spec == sh.step.spec == JP()
    assert all(s.spec == JP() for s in sh.sched)


# ---- meshes and the sharded engine in a world of one ------------------------

def test_worker_mesh_of_a_world_of_one():
    mesh = pmesh.make_worker_mesh(6, device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
    assert mesh.row_range(6) == (0, 6)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(mesh.all_gather_rows(x), x)
    assert torch.equal(mesh.chain_row_sum(x), x[0] + x[1] + x[2])
    assert pmesh.make_host_mesh(1, 1).shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("multi_pod,size", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_ranks(multi_pod, size):
    with pytest.raises(ValueError, match=f"{size} ranks.* has 1"):
        pmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_engine_refusals():
    kw = dict(schedule=AveragingSchedule("periodic", 8), device="cpu")
    with pytest.raises(ValueError, match="collective must be one of"):
        PhaseEngine(tw.port_loss, Momentum(lr=0.1), collective="ring", **kw)
    two = _world_mesh((2,), ("data",))
    eng = PhaseEngine(tw.port_loss, Momentum(lr=0.1), mesh=two, **kw)
    with pytest.raises(ValueError, match="not a multiple of the mesh's 2"):
        eng.init({"w": torch.zeros(3)}, 3)
    with pytest.raises(ValueError, match="only the worker rows"):
        PhaseEngine(tw.port_loss, Momentum(lr=0.1),
                    mesh=_world_mesh((1, 2), ("data", "model")), **kw)
    with pytest.raises(TypeError, match="plane protocol"):
        PhaseEngine(tw.port_loss, object(), mesh=two, **kw)


@pytest.mark.parametrize("coll", tw.COLLECTIVES)
def test_one_rank_mesh_keeps_the_run(coll):
    """A mesh of one rank: ``gather`` bitwise, ``psum`` the same
    decisions and params within its tolerance."""
    base = unsharded("faults-ring-int8")
    got, state, _ = tw.port_run("faults-ring-int8",
                                mesh=pmesh.make_worker_mesh(16,
                                                            device="cpu"),
                                collective=coll)
    assert _decisions(got["hist"]) == _decisions(base["hist"])
    if coll == "gather":
        np.testing.assert_array_equal(got["w"], base["w"])
        np.testing.assert_array_equal(state.plane.numpy(), base["plane"])
    np.testing.assert_allclose(got["w"], base["w"], **PSUM_TOL["params"])


def test_shard_and_unshard_state_round_trip():
    mesh = pmesh.make_worker_mesh(4, device="cpu")
    eng = PhaseEngine(tw.port_loss, Momentum(lr=0.1), device="cpu",
                      schedule=AveragingSchedule("periodic", 8),
                      faults=pf.FaultPlan.parse("crash:m=1@t=2", 4))
    state = eng.init({"w": torch.arange(3.0)}, 4)
    cut = pspecs.shard_engine_state(state, mesh, 4)
    back = pspecs.unshard_engine_state(cut, mesh)
    assert torch.equal(back.plane, state.plane)
    assert np.array_equal(back.fault.alive, state.fault.alive)
    with pytest.raises(ValueError, match="neither the run's 8"):
        pspecs.shard_engine_state(state, pmesh.make_worker_mesh(
            8, device="cpu"), 8)


# ---- the row-sliced fault transition, bit for bit ---------------------------

def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("row0,num_rows", [(0, 4), (4, 4), (10, 6),
                                           (0, 16), (14, 2)])
def test_row_sliced_transition_bitwise(row0, num_rows):
    text = "crash:m=5@t=3,rejoin:m=5@t=7,crash:m=12@t=5"
    p = pf.FaultPlan.parse(text, 16, straggle_prob=0.3, rejoin_curriculum=2)
    j = jf.FaultPlan.parse(text, 16, straggle_prob=0.3, rejoin_curriculum=2)
    kp = rng.split(rng.PRNGKey(4))[1]
    kj = jax.random.split(jax.random.PRNGKey(4))[1]
    sp = pf.init_fault_state(num_rows)
    sj = jf.init_fault_state(num_rows)
    for t in range(1, 14):
        outp = p.transition(sp, t, kp, row0=row0, num_rows=num_rows)
        outj = j.transition(sj, jnp.int32(t), kj, row0=row0,
                            num_rows=num_rows)
        sp, sj = outp[0], outj[0]
        np.testing.assert_array_equal(_bits(sp.alive), _bits(sj.alive))
        np.testing.assert_array_equal(sp.staleness, np.asarray(sj.staleness))
        for a, b in zip(outp[1:], outj[1:]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(
            _bits(p.mix_at(sp.alive, t, row0=row0, num_rows=num_rows)),
            _bits(j.mix_at(jnp.asarray(sp.alive), t, row0=row0,
                           num_rows=num_rows)))
