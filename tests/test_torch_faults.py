"""The port's fault injection against the JAX reference's, on the CPU:
``repro_torch.faults`` against ``repro.faults``, the plane passes'
``alive`` / ``umask`` paths against the reference's twins and Pallas
wrappers (interpret mode), and the engine's fault carry against the
reference's engine, the same numpy draws fed to both.

- ``FaultPlan``: validation and parsing refuse the same plans with the
  same messages; scripted liveness, solo windows, the mixing cohort, the
  straggle draws, ``disp_scale`` and ``transition`` bit for bit over a
  sweep of keys, steps and rows.
- The masked algebra: ``masked_mean``, ``masked_group_mean`` (values:
  a group with no alive member broadcasts zeros whose sign may differ),
  ``masked_event_matrix``, ``degraded_matrix``, ``select_rows``,
  ``zero_rows`` bit for bit; ``masked_dispersion`` within rtol 1e-6 (a
  float32 sum over the alive entries, in another order).
- Each twin against the reference's twin and each wrapper against the
  reference's wrapper: dead rows (and rows outside the update mask)
  bitwise their inputs; the rest within rtol 1e-6 / atol 1e-6 on f32
  columns (``jnp.dot`` sums a mix, and XLA contracts the update into
  FMAs, in other orders; the reference's wrapper runs a masked mean as
  a matrix mix, within (2n + 2) float32 roundings of sum |x| / n of the
  exact one, ``MEAN_ULPS``, under 1e-6 at these magnitudes and M <= 8)
  and one dtype ulp on coded columns; dispersions rtol 1e-5.
- The card paths' logic on CPU tensors (``TestCardPathsOnCpu``: the row
  words, the degraded W and one launch per call, each ctypes caller —
  ``opt_step.cu``, ``compressed_mix.cu``, ``avg_disp.cu`` and
  ``mix_disp.cu`` — replaced by a torch emulation of its kernel's
  column pass) held by ``card_check.fault_sweep``'s criteria; the
  emulated ``avg_disp.cu`` / ``mix_disp.cu`` bitwise their plain
  versions over row masks x groups x codes x M; rows in a solo window
  keep their step; ``_build.row_bits``' bit order and refusals.
- The engine's coded events through the emulated kernels
  (``TestCodedEventsOnCpu``): periodic, hierarchical and ring events on
  a bf16 + f32 plane, with and without a plan, one ``avg_disp`` /
  ``mix_disp`` launch an event, bitwise ``kernel_impl="ref"``; and the
  coded outer step (``TestCodedOuterOnCpu``): ``avg_disp_outer``'s card
  path over an emulated ``avg_disp_outer.cu`` bitwise
  ``avg_disp_outer_ref(codes=)`` for bf16, f16 and mixed codes, and the
  engine's periodic and minibatch outer events on a coded plane one
  launch each, never the plain version.
- The engine under ``crash:m=1@t=6,rejoin:m=1@t=14`` with straggles
  (0.1) over all seven schedules, a ring, int8, rejoin curricula,
  straggle-aware schedules and a bf16 weight: decisions, ``averages``,
  event steps, ``alive`` and ``staleness`` equal; params rtol 1e-6 /
  atol 1e-7, dispersion rtol 1e-5, losses allclose (rtol 1e-6 / atol
  1e-7); the bf16 cases one bf16 ulp (rtol 2**-8), losses and
  dispersion rtol 1e-4. An all-alive plan is the no-fault engine bit for
  bit, and ``run_host`` is ``run`` bit for bit under faults.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jf  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro import topology as jtopo  # noqa: E402
from repro.core.averaging import AveragingSchedule as JSched  # noqa: E402
from repro.core.averaging import OuterOptimizer as JOuter  # noqa: E402
from repro.core.compress import Compression as JComp  # noqa: E402
from repro.core.engine import PhaseEngine as JEngine  # noqa: E402
from repro.core.engine import tree_stack  # noqa: E402
from repro.kernels import avg_disp as jad  # noqa: E402
from repro.kernels import opt_step as jos  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import faults as pf  # noqa: E402
from repro_torch import optim as popt  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch import topology as ptopo  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import AveragingSchedule, PhaseEngine  # noqa: E402
from repro_torch.core.averaging import OuterOptimizer  # noqa: E402
from repro_torch.core.compress import Compression  # noqa: E402
from repro_torch.core.compress import encode_decode  # noqa: E402
from repro_torch.data import convex_dataset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import avg_disp as pad  # noqa: E402
from repro_torch.kernels import card_check as cc  # noqa: E402
from repro_torch.kernels import opt_step as pos  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.kernels.avg_disp import (avg_disp,  # noqa: E402
                                          compressed_mix, mix_disp)
from repro_torch.kernels.opt_step import opt_step  # noqa: E402

WORKERS, DIM, STEPS = 4, 64, 24
_PLAN = "crash:m=1@t=6,rejoin:m=1@t=14"
TOL = dict(params=dict(rtol=1e-6, atol=1e-7), loss=dict(rtol=1e-6,
                                                         atol=1e-7),
           disp=dict(rtol=1e-5))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _refusal(make_jax, make_port) -> tuple[str, str]:
    with pytest.raises(ValueError) as ej:
        make_jax()
    with pytest.raises(ValueError) as ep:
        make_port()
    return str(ep.value), str(ej.value)


# ---- FaultPlan --------------------------------------------------------------

class TestFaultPlan:
    @pytest.mark.parametrize("text,kw", [
        (_PLAN, dict(straggle_prob=0.25)),
        ("crash:m=2@t=5", dict(rejoin_after=7)),
        (_PLAN, dict(rejoin_after=7)),
        ("crash:m=3@t=9, crash:m=0@t=2 ,rejoin:m=0@t=4",
         dict(rejoin_after=3, rejoin_curriculum=2)),
        ("", dict(straggle_prob=0.5)),
    ])
    def test_parse_matches_jax(self, text, kw):
        p = pf.FaultPlan.parse(text, WORKERS, **kw)
        j = jf.FaultPlan.parse(text, WORKERS, **kw)
        assert p.events == j.events
        assert (p.straggle_prob, p.rejoin_curriculum) == (
            j.straggle_prob, j.rejoin_curriculum)
        assert p._solo_windows == j._solo_windows
        assert (p.is_trivial, p.has_rejoin) == (j.is_trivial, j.has_rejoin)
        assert p.events_in(0, 6) == j.events_in(0, 6)

    @pytest.mark.parametrize("text,kw", [
        ("crash:m=9@t=2", {}),
        ("explode:m=1@t=2", {}),
        ("crash m=1@t=2", {}),
        ("rejoin:m=1@t=2", {}),
        ("crash:m=1@t=2,crash:m=1@t=5", {}),
        ("crash:m=0@t=2,crash:m=1@t=2,crash:m=2@t=2,crash:m=3@t=2", {}),
        ("crash:m=1@t=0", {}),
        ("crash:m=1@t=2,rejoin:m=1@t=2", {}),
        ("crash:m=1@t=2,crash:m=2@t=2,crash:m=3@t=2,rejoin:m=1@t=5,"
         "crash:m=0@t=6", dict(rejoin_curriculum=3)),
        ("", dict(straggle_prob=1.5)),
        ("crash:m=1@t=2", dict(rejoin_curriculum=-1)),
    ], ids=range(11))
    def test_invalid_plans_refused_as_jax(self, text, kw):
        got, want = _refusal(lambda: jf.FaultPlan.parse(text, WORKERS, **kw),
                             lambda: pf.FaultPlan.parse(text, WORKERS, **kw))
        assert got == want

    @pytest.mark.parametrize("kw", [
        dict(num_workers=0), dict(solo=((9, 1, 3),)),
        dict(solo=((1, 3, 3),)), dict(solo=((1, 2),)),
    ], ids=["workers", "solo-row", "solo-span", "solo-arity"])
    def test_invalid_fields_refused_as_jax(self, kw):
        kw = dict(dict(num_workers=WORKERS), **kw)
        got, want = _refusal(lambda: jf.FaultPlan(**kw),
                             lambda: pf.FaultPlan(**kw))
        assert got == want

    @pytest.mark.parametrize("args", [(8, 5, 10), (4, 4, 3), (5, 0, 2)])
    def test_shrink_matches_jax(self, args):
        if args[1] < 1:
            got, want = _refusal(lambda: jf.FaultPlan.shrink(*args),
                                 lambda: pf.FaultPlan.shrink(*args))
            assert got == want
            return
        p, j = pf.FaultPlan.shrink(*args), jf.FaultPlan.shrink(*args)
        assert p.events == j.events
        for t in range(1, 14):
            np.testing.assert_array_equal(p.alive_at(t),
                                          np.asarray(j.alive_at(t)))

    @pytest.mark.parametrize("args,kw", [((4, 6, 5), {}),
                                         ((4, 6, 5),
                                          dict(rejoin_curriculum=3)),
                                         ((4, 6, 1), {})])
    def test_grow_matches_jax(self, args, kw):
        if args[2] < 2:
            got, want = _refusal(lambda: jf.FaultPlan.grow(*args, **kw),
                                 lambda: pf.FaultPlan.grow(*args, **kw))
            assert got == want
            return
        p, j = pf.FaultPlan.grow(*args, **kw), jf.FaultPlan.grow(*args, **kw)
        assert p.events == j.events and p._solo_windows == j._solo_windows

    def test_trivial_plan_lowers_away(self):
        assert pf.FaultPlan(WORKERS).is_trivial
        eng = PhaseEngine(_ploss, popt.SGD(0.05),
                          AveragingSchedule("periodic", phase_len=8),
                          device="cpu", faults=pf.FaultPlan(WORKERS))
        assert eng._faults() is None
        assert eng.init({"w": torch.zeros(DIM)}, WORKERS).fault == ()

    @pytest.mark.parametrize("bad", ["workers", "outer"])
    def test_engine_refusals_match_jax(self, bad):
        plan = (dict(text="crash:m=1@t=2", m=8) if bad == "workers"
                else dict(text="crash:m=1@t=2", m=WORKERS))
        outer = bad == "outer"
        jeng = JEngine(_jloss, jopt.SGD(0.05), JSched("periodic", 8),
                       outer=JOuter(lr=0.8, momentum=0.5) if outer else None,
                       faults=jf.FaultPlan.parse(plan["text"], plan["m"]))
        peng = PhaseEngine(
            _ploss, popt.SGD(0.05), AveragingSchedule("periodic",
                                                      phase_len=8),
            device="cpu",
            outer=OuterOptimizer(lr=0.8, momentum=0.5) if outer else None,
            faults=pf.FaultPlan.parse(plan["text"], plan["m"]))
        b = [jax.tree.map(jnp.asarray, bt) for bt in _batches(2)]
        got, want = _refusal(
            lambda: jeng.run({"w": jnp.zeros(DIM)}, b, num_workers=WORKERS),
            lambda: peng.init({"w": torch.zeros(DIM)}, WORKERS))
        assert got == want


# ---- the per-step streams ---------------------------------------------------

CURRICULUM_PLAN = dict(text="crash:m=1@t=3,crash:m=2@t=4,rejoin:m=1@t=7,"
                            "rejoin:m=2@t=9", straggle_prob=0.3,
                       rejoin_curriculum=3)


class TestStreams:
    def _plans(self):
        kw = dict(CURRICULUM_PLAN)
        text = kw.pop("text")
        return (pf.FaultPlan.parse(text, WORKERS, **kw),
                jf.FaultPlan.parse(text, WORKERS, **kw))

    def test_liveness_solo_and_cohort_match_jax(self):
        p, j = self._plans()
        for t in range(1, 16):
            np.testing.assert_array_equal(p.alive_at(t),
                                          np.asarray(j.alive_at(t)))
            np.testing.assert_array_equal(p.solo_at(t),
                                          np.asarray(j.solo_at(t)))
            a = p.alive_at(t)
            np.testing.assert_array_equal(
                _bits(p.mix_at(a, t)), _bits(j.mix_at(jnp.asarray(a), t)))

    def test_mix_at_without_windows_is_alive_itself(self):
        plan = pf.FaultPlan.parse(_PLAN, WORKERS)
        a = plan.alive_at(8)
        assert plan.mix_at(a, 8) is a

    @pytest.mark.parametrize("seed", [0, 3, 12345, -7])
    @pytest.mark.parametrize("step", [1, 2, 17, 1000, 2**20 + 3])
    def test_straggle_mask_bitwise(self, seed, step):
        p = pf.FaultPlan(24, (), 0.37)
        j = jf.FaultPlan(24, (), 0.37)
        kp = rng.split(rng.PRNGKey(seed))[1]
        kj = jax.random.split(jax.random.PRNGKey(seed))[1]
        for rows in (np.arange(24), np.arange(24)[5:], [9, 2, 17]):
            np.testing.assert_array_equal(
                p.straggle_mask(kp, step, rows),
                np.asarray(j.straggle_mask(kj, jnp.int32(step),
                                           jnp.asarray(rows, jnp.int32))))

    def test_straggle_draws_follow_the_probability(self):
        plan = pf.FaultPlan(24, (), 0.25)
        key = rng.split(rng.PRNGKey(0))[1]
        share = np.mean([plan.straggle_mask(key, t, np.arange(24))
                         for t in range(1, 201)])
        assert 0.2 < share < 0.3
        assert not pf.FaultPlan(24).straggle_mask(key, 3, range(24)).any()

    @pytest.mark.parametrize("seed", [0, 5])
    def test_transition_and_disp_scale_bitwise(self, seed):
        p, j = self._plans()
        kp = rng.split(rng.PRNGKey(seed))[1]
        kj = jax.random.split(jax.random.PRNGKey(seed))[1]
        sp, sj = pf.init_fault_state(WORKERS), jf.init_fault_state(WORKERS)
        for t in range(1, 20):
            outp = p.transition(sp, t, kp)
            outj = j.transition(sj, jnp.int32(t), kj)
            sp, sj = outp[0], outj[0]
            np.testing.assert_array_equal(_bits(sp.alive), _bits(sj.alive))
            np.testing.assert_array_equal(sp.staleness,
                                          np.asarray(sj.staleness))
            assert sp.staleness.dtype == np.int32
            for a, b in zip(outp[1:], outj[1:]):
                np.testing.assert_array_equal(_bits(a), _bits(b))
            np.testing.assert_array_equal(
                _bits(p.disp_scale(outp[1], kp, t)),
                _bits(j.disp_scale(outj[1], kj, jnp.int32(t))))


# ---- the masked algebra -----------------------------------------------------

ALGEBRA = [(4, 7, 2), (8, 300, 4), (24, 1024, 4), (6, 33, 3)]


def _masks(m, seed):
    r = np.random.default_rng(seed)
    a = (r.random(m) < 0.6).astype(np.float32)
    a[r.integers(m)] = 1.0
    return a


class TestMaskedAlgebra:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("shape", ALGEBRA, ids=lambda s: "M{}P{}G{}"
                             .format(*s))
    def test_plane_primitives_match_jax(self, shape, seed):
        m, p, g = shape
        x = np.random.default_rng(seed).standard_normal((m, p)).astype(
            np.float32)
        a = _masks(m, seed)
        X, xj, aj = torch.from_numpy(x), jnp.asarray(x), jnp.asarray(a)
        np.testing.assert_array_equal(
            _bits(pf.masked_mean(X, a)), _bits(jf.masked_mean(xj, aj)))
        np.testing.assert_array_equal(
            pf.masked_group_mean(X, a, g).numpy(),
            np.asarray(jf.masked_group_mean(xj, aj, g)))
        np.testing.assert_allclose(float(pf.masked_dispersion(X, a)),
                                   float(jf.masked_dispersion(xj, aj)),
                                   rtol=1e-6)
        for fn in ("select_rows", "zero_rows"):
            args = (X, 2 * X) if fn == "select_rows" else (X,)
            jargs = (xj, 2 * xj) if fn == "select_rows" else (xj,)
            np.testing.assert_array_equal(
                _bits(getattr(pf, fn)(*args, a)),
                _bits(getattr(jf, fn)(*jargs, aj)))

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    @pytest.mark.parametrize("m,g", [(4, 1), (4, 2), (8, 4), (24, 4),
                                     (6, 3)])
    def test_matrices_match_jax(self, m, g, seed):
        a = _masks(m, seed)
        np.testing.assert_array_equal(
            _bits(pf.masked_event_matrix(a, g)),
            _bits(jf.masked_event_matrix(jnp.asarray(a), g)))
        r = np.random.default_rng(seed)
        W = r.random((m, m))
        W = W + W.T
        for _ in range(60):  # Sinkhorn to doubly stochastic
            W = W / W.sum(1, keepdims=True)
            W = W / W.sum(0, keepdims=True)
        for Wn in (W.astype(np.float32),
                   ptopo.Topology.ring(m).mixing_matrix().numpy()):
            np.testing.assert_array_equal(
                _bits(pf.degraded_matrix(torch.from_numpy(Wn), a)),
                _bits(jf.degraded_matrix(jnp.asarray(Wn), jnp.asarray(a))))

    def test_degraded_matrix_all_alive_is_w(self):
        W = ptopo.Topology.ring(5).mixing_matrix()
        assert pf.degraded_matrix(W, np.ones(5, np.float32)) is W

    def test_event_matrix_is_doubly_stochastic_with_identity_dead_rows(self):
        a = np.array([1, 0, 1, 1], np.float32)
        A = pf.masked_event_matrix(a).numpy()
        np.testing.assert_allclose(A.sum(0), 1.0, atol=1e-6)
        np.testing.assert_allclose(A.sum(1), 1.0, atol=1e-6)
        np.testing.assert_array_equal(A[1], np.eye(4)[1])


# ---- twins and wrappers -----------------------------------------------------

def _plane_inputs(m, p, kind, codes, seed):
    x, g, st, scal, cd = cc.make_inputs(torch.device("cpu"), m, p, kind,
                                        codes, seed=seed)
    r, u = cc.wire_inputs(torch.device("cpu"), m, p, seed=seed)
    return x, g, st, scal, cd, r, u


def _j(t):
    return None if t is None else jnp.asarray(t.numpy())


def _hold(name, got, want, kept, keep_mask, codes=None):
    """Rows outside ``keep_mask`` bitwise ``kept``; the others within the
    module's tolerance of ``want`` (numpy)."""
    want = torch.from_numpy(np.array(want))
    cc.max_err(name, got[torch.from_numpy(keep_mask > 0)],
               want[torch.from_numpy(keep_mask > 0)], codes, atol=1e-6)
    for i in np.flatnonzero(keep_mask <= 0):
        assert torch.equal(got[i], kept[i]), (name, i)


#: float32 units of rounding per cohort row between a masked mean run as
#: the mix ``A @ x`` (the reference's wrapper, ``faults.masked_event_matrix``)
#: and the exact sum over the n alive rows divided once: each side is
#: within (n + 1) units of sum_j |x_j| / n of the exact mean, so the two
#: within (MEAN_ULPS * n + MEAN_ULPS) * 2**-24 * sum_j |x_j| / n
MEAN_ULPS = 2


def _mean_bounds(q, alive, groups: int) -> list:
    """Per group, the (P,) bound on |A @ q - exact masked mean|
    (``MEAN_ULPS``)."""
    m = q.shape[0]
    mg = m // groups
    out = []
    for g in range(groups):
        rows = [i for i in range(g * mg, (g + 1) * mg) if alive[i] > 0]
        s = torch.zeros_like(q[0])
        for j in rows:
            s += q[j].abs()
        n = max(len(rows), 1)
        out.append(s * (MEAN_ULPS * (n + 1) * 2.0 ** -24 / n))
    return out


FAULT_MASKS = {"dead": (np.array([1, 0, 1, 1, 1, 1, 0, 1], np.float32),
                        np.array([1, 0, 1, 1, 1, 1, 0, 1], np.float32)),
               "straggle": (np.array([1, 0, 1, 1, 1, 1, 0, 1], np.float32),
                            np.array([0, 0, 1, 1, 1, 0, 0, 1], np.float32))}


class TestFaultWrappers:
    M, P = 8, 301

    @pytest.mark.parametrize("mask", list(FAULT_MASKS))
    @pytest.mark.parametrize("codes", [None, "mixed"], ids=["f32", "codes"])
    @pytest.mark.parametrize("mode", ["none", "mean", "group", "mix"])
    @pytest.mark.parametrize("kind", ["sgd", "momentum", "adamw"])
    def test_opt_step_matches_jax(self, kind, mode, codes, mask):
        alive, umask = FAULT_MASKS[mask]
        x, g, st, scal, cd, _, _ = _plane_inputs(self.M, self.P, kind,
                                                 codes, seed=3)
        W = ptopo.Topology.ring(self.M).mixing_matrix()
        hyp = dict(cc.OPTS["adamw" if kind == "adamw" else kind][1])
        kw = dict(kind=kind, mode=mode, groups=2 if mode == "group" else 1,
                  **hyp)
        jkw = dict(kw, W=_j(W) if mode == "mix" else None, codes=_j(cd),
                   alive=jnp.asarray(alive), umask=jnp.asarray(umask))
        jargs = (_j(x), _j(g), tuple(map(_j, st)), _j(scal))
        got = opt_step(x.clone(), g, tuple(s.clone() for s in st), scal,
                       W=W if mode == "mix" else None, codes=cd,
                       alive=alive, umask=umask, **kw)
        twin = pref.opt_step_ref(x, g, st, scal,
                                 W=W if mode == "mix" else None, codes=cd,
                                 alive=alive, umask=umask, **kw)
        for want in (jref.opt_step_ref(*jargs, **jkw),
                     jos.opt_step(*jargs, interpret=True, **jkw)):
            for out in (got, twin):
                keep = umask if mode == "none" else alive
                _hold(f"{kind}-{mode}", out[0], want[0], x, keep, cd)
                for a, b, s0 in zip(out[1], want[1], st):
                    _hold("state", a, b, s0, umask)
                np.testing.assert_allclose(float(out[2]), float(want[2]),
                                           rtol=1e-5)

    @pytest.mark.parametrize("mask", list(FAULT_MASKS))
    @pytest.mark.parametrize("groups", [1, 2, 4])
    def test_avg_disp_matches_jax(self, groups, mask):
        alive = FAULT_MASKS[mask][0]
        x = _plane_inputs(self.M, self.P, "sgd", None, seed=4)[0]
        got = avg_disp(x, groups=groups, alive=alive)
        for want in (jref.avg_disp_ref(_j(x), groups=groups,
                                       alive=jnp.asarray(alive)),
                     jad.avg_disp(_j(x), groups=groups,
                                  alive=jnp.asarray(alive),
                                  interpret=True)):
            _hold("avg_disp", got[0], want[0], x, alive)
            np.testing.assert_allclose(float(got[1]), float(want[1]),
                                       rtol=1e-5)

    @pytest.mark.parametrize("codes", [None, "mixed"], ids=["f32", "codes"])
    @pytest.mark.parametrize("topo", ["ring", "torus", "hypercube"])
    def test_mix_disp_matches_jax(self, topo, codes):
        alive = FAULT_MASKS["dead"][0]
        x, _, _, _, cd, _, _ = _plane_inputs(self.M, self.P, "sgd", codes,
                                             seed=5)
        W = ptopo.Topology.build(topo, self.M).mixing_matrix()
        twin = jref.mix_disp_ref(_j(x), _j(W), codes=_j(cd),
                                 alive=jnp.asarray(alive))
        wants = [twin, twin]
        outs = [pref.mix_disp_ref(x, W, codes=cd, alive=alive),
                mix_disp(x, W, codes=cd, alive=alive)]
        if cd is None:  # the reference's kernel takes no codes
            wants.append(jad.mix_disp(_j(x), _j(W), alive=jnp.asarray(alive),
                                      interpret=True))
            outs.append(mix_disp(x, W, alive=alive))
        for got, want in zip(outs, wants):
            _hold("mix_disp", got[0], want[0], x, alive, cd)
            np.testing.assert_allclose(float(got[1]), float(want[1]),
                                       rtol=1e-5)

    @pytest.mark.parametrize("mask", list(FAULT_MASKS))
    @pytest.mark.parametrize("mode", ["mean", "group", "mix"])
    @pytest.mark.parametrize("wire", ["bf16", "int8", "one_bit"])
    def test_compressed_mix_matches_jax(self, wire, mode, mask):
        alive = FAULT_MASKS[mask][0]
        x, _, _, _, cd, r, u = _plane_inputs(self.M, self.P, "sgd",
                                             "mixed", seed=6)
        u = u if wire == "int8" else None
        W = ptopo.Topology.ring(self.M).mixing_matrix() if mode == "mix" \
            else None
        kw = dict(wire=wire, mode=mode, groups=2 if mode == "group" else 1)
        got = compressed_mix(x.clone(), r.clone(), W=W, u=u, codes=cd,
                             alive=alive, **kw)
        jkw = dict(wire=wire, u=_j(u), codes=_j(cd),
                   alive=jnp.asarray(alive))
        if mode == "mix":
            twin = jref.compressed_mix_ref(_j(x), _j(r), _j(W), **jkw)
        else:
            twin = jref.compressed_avg_ref(_j(x), _j(r),
                                           groups=kw["groups"], **jkw)
        kern = jad.compressed_mix(_j(x), _j(r), mode=mode,
                                  groups=kw["groups"], W=_j(W),
                                  interpret=True, **jkw)
        for want in (twin, kern):
            _hold("compressed", got[0], want[0], x, alive, cd)
            _hold("resid", got[1], want[1], r, alive)
            np.testing.assert_allclose(float(got[2]), float(want[2]),
                                       rtol=1e-5)

    def test_wrapper_bounds_hold_jax_matrix_means(self):
        """The masked-mean bound (``_mean_bounds``) holds the reference's
        matrix mean (its Pallas wrapper) against the port's exact twin:
        dead rows bitwise, alive rows within the bound of their group."""
        for seed, (alive, _) in enumerate(FAULT_MASKS.values()):
            x = _plane_inputs(self.M, 4097, "sgd", None, seed=seed)[0]
            for g in (1, 2, 4):
                want = pref.plane_average_ref(x, groups=g, alive=alive)[0]
                got = torch.from_numpy(np.array(jad.avg_disp(
                    _j(x), groups=g, alive=jnp.asarray(alive),
                    interpret=True)[0]))
                bounds = _mean_bounds(x, alive, g)
                for i in range(self.M):
                    if alive[i] <= 0:
                        assert torch.equal(got[i], x[i]), (g, i)
                    else:
                        d = (got[i] - want[i]).abs()
                        assert bool((d <= bounds[i // (self.M // g)])
                                    .all()), (g, i, float(d.max()))

    @pytest.mark.parametrize("mask", list(FAULT_MASKS))
    def test_card_check_fault_sweep_runs_on_cpu(self, mask):
        """The card's fault checks, on CPU tensors (the plain versions on
        both sides): their row bookkeeping holds on every path."""
        alive, umask = FAULT_MASKS[mask]
        x, g, st, scal, cd, r, u = _plane_inputs(self.M, 257, "momentum",
                                                 "mixed", seed=9)
        W = ptopo.Topology.ring(self.M).mixing_matrix()
        cc.check_avg_disp_fault("a", x, alive, 2)
        cc.check_mix_disp_fault("m", x, W, alive)
        cc.check_compressed_fault("c", x, r, alive, wire="int8", mode="mix",
                                  W=W, u=u, codes=cd)
        cc.check_opt_step_fault("o", x, g, st, scal, cd, alive, umask,
                                kind="momentum", mu=0.9, mode="mean")
        cc.check_opt_step_fault("w", x, g, st, scal, None, alive, umask,
                                resid=r, kind="momentum", mu=0.9,
                                mode="mean", wire="one_bit")


def _bit_rows(bits, m) -> list:
    """The rows set in a kernel's 64-bit row word."""
    return [i for i in range(m) if bits >> i & 1]


def _masked_disp(u, alive):
    """The column pass's Eq. 4 term over the alive rows (their sum in
    row order from 0, divided once by their count; the squared
    deviations summed in the same order), its partials summed in double
    and divided by the count."""
    n = torch.tensor(float(len(alive)))
    s = torch.zeros_like(u[alive[0]])
    for i in alive:
        s += u[i]
    mean = s / n
    dsq = torch.zeros_like(mean)
    for i in alive:
        d = u[i] - mean
        dsq += d * d
    return dsq.double().sum().float() / n


def _write_event(plane, u, alive, mode, groups, W, codes):
    """The masked event of the column pass, into the alive rows only:
    ``W`` (the degraded one) over the alive columns in order, or the
    alive rows of each group summed in order and divided once."""
    m = plane.shape[0]

    def rounded(v):
        return v if codes is None else pref.round_to_codes(v, codes)

    if mode == "mix":
        for i in alive:
            acc = torch.zeros_like(plane[0])
            for k in alive:
                acc += W[i, k] * u[k]
            plane[i] = rounded(acc)
        return
    gs = m // groups if mode == "group" else m
    for lo in range(0, m, gs):
        rows = [i for i in alive if lo <= i < lo + gs]
        if not rows:
            continue
        s = torch.zeros_like(plane[0])
        for i in rows:
            s += u[i]
        out = rounded(s / torch.tensor(float(len(rows))))
        for i in rows:
            plane[i] = out


def _emulated_opt_step_cu(plane, grads, planes, codes, W, dpart, disp, *,
                          kind, mode, groups, lr, c1, c2, masks, **hyp):
    """``opt_step_launch`` in torch on CPU tensors, in place: the masked
    instantiation's rows from the two row words (the unmasked one's: all
    rows), only the update rows stepped (their g and state read and
    written), the old x of the other alive rows, the dispersion over the
    alive rows, the event into the alive rows, and no write to a row in
    neither word."""
    m = plane.shape[0]
    everyone = (1 << m) - 1
    alive_b, update_b = masks if masks is not None else (everyone, everyone)
    alive, update = _bit_rows(alive_b, m), _bit_rows(update_b, m)
    u = {}
    if update:
        idx = torch.tensor(update)
        upd, st = pref.plane_update_ref(
            plane[idx], grads[idx], tuple(s[idx] for s in planes),
            torch.tensor([lr, c1, c2, 0.0]), kind=kind, codes=codes, **hyp)
        for k, i in enumerate(update):
            u[i] = upd[k]
            for s, n in zip(planes, st):
                s[i] = n[k]
    for i in alive:
        u.setdefault(i, plane[i].clone())
    disp.copy_(_masked_disp(u, alive))
    for i in update:
        if mode == "none" or i not in alive:
            plane[i] = u[i]
    if mode != "none":
        _write_event(plane, u, alive, mode, groups, W, codes)
    return 0


def _emulated_compressed_mix_cu(plane, resid, u, codes, W, rowpart, scales,
                                dpart, disp, *, wire, mode, groups,
                                error_feedback, alive_bits):
    """``compressed_mix_launch`` in torch on CPU tensors, in place: the
    alive rows (all rows unmasked) encoded with their residuals, the
    pre-encode dispersion over them, the event of their decoded rows into
    them; a dead row neither read nor written."""
    m = plane.shape[0]
    alive = _bit_rows((1 << m) - 1 if alive_bits is None else alive_bits, m)
    idx = torch.tensor(alive)
    disp.copy_(_masked_disp({i: plane[i] for i in alive}, alive))
    q, r = encode_decode(plane[idx], resid[idx], wire=wire,
                         u=None if u is None else u[idx],
                         error_feedback=error_feedback)
    for k, i in enumerate(alive):
        resid[i] = r[k]
    _write_event(plane, dict(zip(alive, q)), alive, mode, groups, W, codes)
    return 0


def _emulated_avg_disp_cu(plane, out, codes, disp, *, groups, alive_bits):
    """``avg_disp_launch`` in torch on CPU tensors: the rows of the row
    word (all rows unmasked) read, the dispersion over them, the (group)
    means of their rows into those rows of ``out`` (the plane itself
    when masked); no other row read or written."""
    m = plane.shape[0]
    alive = _bit_rows((1 << m) - 1 if alive_bits is None else alive_bits, m)
    u = {i: plane[i].clone() for i in alive}
    disp.copy_(_masked_disp(u, alive))
    _write_event(out, u, alive, "group", groups, None, codes)
    return 0


def _emulated_mix_disp_cu(plane, W, out, codes, dpart, disp, *,
                          alive_bits):
    """``mix_disp_launch`` in torch on CPU tensors: the rows of the row
    word read, the pre-mix dispersion over them, their rows of ``W @``
    (over their columns) into those rows of ``out``; no other row read
    or written."""
    m = plane.shape[0]
    alive = _bit_rows((1 << m) - 1 if alive_bits is None else alive_bits, m)
    u = {i: plane[i].clone() for i in alive}
    disp.copy_(_masked_disp(u, alive))
    _write_event(out, u, alive, "mix", 1, W, codes)
    return 0


def _card_events(monkeypatch):
    """``avg_disp`` / ``mix_disp``'s card paths on CPU tensors, their
    ctypes callers replaced by the emulations above. Returns the two
    card-path functions, with the wrappers' signatures."""
    monkeypatch.setattr(pad, "_avg_launch", _emulated_avg_disp_cu)
    monkeypatch.setattr(pad, "_mix_launch", _emulated_mix_disp_cu)

    def avg(plane, *, groups=1, codes=None, alive=None):
        return pad._card_avg(plane, groups=groups, codes=codes, alive=alive)

    def mix(plane, W, *, codes=None, alive=None):
        return pad._card_mix(plane, W, codes=codes, alive=alive)
    return avg, mix


#: opt_step's keyword defaults, which the card step takes explicitly
_OPT_DEFAULTS = {k: v.default for k, v in
                 inspect.signature(pos.opt_step).parameters.items()
                 if v.default is not inspect.Parameter.empty}


class TestCardPathsOnCpu:
    """The fault paths' card-side logic on CPU tensors: ``opt_step``,
    ``compressed_mix``, ``avg_disp`` and ``mix_disp`` reach their
    kernels' ctypes callers through the card path (row words, the
    degraded W, codes, one launch each), each caller replaced by a torch
    emulation of its column pass. Held by ``card_check.fault_sweep``'s
    criteria (the card's) to the exact masked plain versions."""

    @pytest.fixture
    def card(self, monkeypatch):
        avg, mix = _card_events(monkeypatch)

        def compressed(plane, resid, *, mode="mean", groups=1, W=None,
                       **kw):
            return plane, resid, pad._compressed_event(
                plane, resid, mode=mode, groups=groups, W=W, **kw)

        def opt(plane, grads, planes, scalars, **kw):
            return pos._card_step(plane, grads, planes, scalars,
                                  **{**_OPT_DEFAULTS, **kw})

        monkeypatch.setattr(pos, "_launch", _emulated_opt_step_cu)
        monkeypatch.setattr(pad, "_compressed_launch",
                            _emulated_compressed_mix_cu)
        for name, fn in (("avg_disp", avg), ("mix_disp", mix),
                         ("compressed_mix", compressed), ("opt_step", opt)):
            monkeypatch.setattr(cc, name, fn)

    @pytest.mark.parametrize("shape", [(4, 1001, 2), (8, 503, 4),
                                       (24, 257, 4)],
                             ids=lambda s: "M{}P{}".format(*s))
    def test_fault_sweep_holds_the_card_logic(self, card, shape,
                                              monkeypatch):
        monkeypatch.setattr(cc, "COMM_SHAPES", [shape])
        n0 = cc._launch_counts()
        n, err = cc.fault_sweep(torch.device("cpu"))
        assert n == 3 * 37 + 1
        # every masked pass is bitwise (its launches checked case by
        # case: one of its own kernel each, so no mix_disp for a mean)
        assert err == dict.fromkeys(err, 0.0)
        # two runs of each of 3 masks x (16 opt_step cases and 3 wire
        # cases; 9 compressed events and those 3; 3 codes x (ring mix,
        # 2 group counts of avg_disp)), and of the empty-group avg_disp
        launched = [a - b for a, b in zip(cc._launch_counts(), n0)]
        assert launched == [2 * 3 * 19, 2 * 3 * 12, 2 * 3 * 3,
                            2 * (3 * 6 + 1)]

    def test_sweep_holds_the_card_logic(self, card, monkeypatch):
        """card_check's unmasked sweep through the same card paths, at
        one shape of each list: every kernel bitwise (``avg_disp`` and
        ``mix_disp`` over every codes kind), one launch a call."""
        monkeypatch.setattr(cc, "SHAPES", [(8, 300, 4)])
        monkeypatch.setattr(cc, "NARROW_SHAPES", [(24, 32)])
        monkeypatch.setattr(cc, "COMM_SHAPES", [(4, 257, 2)])
        n0 = cc._launch_counts()
        n, err = cc.sweep(torch.device("cpu"))
        # SHAPES: 4 optimizers x 3 modes x 2 codes, 3 groups x 3 codes;
        # NARROW_SHAPES: 4 x 2 x 2, 3 groups; COMM_SHAPES: 4 mixes x (3
        # codes + 2 opt_step), 2 outer x 3 codes, 3 wires x 3 modes x 2 x
        # 2 x 2
        assert n == 24 + 9 + 16 + 3 + 20 + 6 + 72
        assert err == dict.fromkeys(err, 0.0)
        launched = [a - b for a, b in zip(cc._launch_counts(), n0)]
        assert launched == [2 * (24 + 16 + 8 + 36), 2 * 72, 2 * 12,
                            2 * (9 + 3)]

    @pytest.mark.parametrize("mode", ["none", "mean", "group", "mix",
                                      "wire"])
    def test_solo_rows_keep_their_step(self, card, mode):
        """A rejoining row inside its solo window is in the update mask
        and outside the event's cohort: it takes its step and keeps it."""
        alive = np.array([1, 0, 1, 0, 1, 1, 1, 1], np.float32)
        umask = np.array([0, 0, 1, 1, 1, 1, 1, 1], np.float32)
        x, g, st, scal, cd, r, u = _plane_inputs(8, 333, "momentum",
                                                 "mixed", seed=12)
        W = ptopo.Topology.ring(8).mixing_matrix()
        kw = dict(kind="momentum", mu=0.9,
                  mode="mix" if mode in ("mix", "wire") else mode,
                  groups=4 if mode == "group" else 1,
                  W=W if mode in ("mix", "wire") else None)
        if mode == "wire":
            kw.update(wire="one_bit", resid=r)
        assert cc.check_opt_step_fault(mode, x, g, st, scal, cd, alive,
                                       umask, **kw) == 0.0


def _event_masks(m) -> dict:
    """Row masks of the event kernels over M rows: none (unmasked), dead
    rows (card_check's), the first half's rows and one more dead (a
    group mean with no alive row at groups 2 and 4), and all alive."""
    return {"none": None, "dead": cc.fault_masks(m)["dead"][0],
            "empty-group": cc.empty_group_mask(m, 2),
            "all-alive": np.ones(m, np.float32)}


def _held_event(got, want, x, alive):
    """The card path's plane against the plain version's: bitwise, dead
    rows bitwise their inputs; the dispersion within rtol 1e-5."""
    assert torch.equal(got[0], want[0])
    if alive is not None:
        for i in np.flatnonzero(alive <= 0):
            assert torch.equal(got[0][i], x[i])
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)


class TestEventKernelsOnCpu:
    """The emulated ``avg_disp.cu`` / ``mix_disp.cu`` passes through the
    wrappers' card paths (row word, degraded W, codes row; one launch a
    call, in place under a mask) bitwise the plain versions."""

    @pytest.mark.parametrize("m", [4, 8, 24])
    @pytest.mark.parametrize("codes", list(cc.CODE_KINDS),
                             ids=["f32", "bf16", "mixed"])
    @pytest.mark.parametrize("groups", [1, 2, 4])
    @pytest.mark.parametrize("mask", ["none", "dead", "empty-group",
                                      "all-alive"])
    def test_avg_disp_card_path_is_the_plain_version(self, monkeypatch, mask,
                                                     groups, codes, m):
        avg, _ = _card_events(monkeypatch)
        alive = _event_masks(m)[mask]
        x, _, _, _, cd = cc.make_inputs(torch.device("cpu"), m, 257, "sgd",
                                        codes, seed=m + groups)
        want = pref.plane_average_ref(x, groups=groups, codes=cd,
                                      alive=alive)
        xk, n0 = x.clone(), pad.avg_disp.launches
        got = avg(xk, groups=groups, codes=cd, alive=alive)
        assert pad.avg_disp.launches == n0 + 1
        assert (got[0] is xk) == (alive is not None)
        _held_event(got, want, x, alive)

    @pytest.mark.parametrize("m", [4, 8, 24])
    @pytest.mark.parametrize("codes", list(cc.CODE_KINDS),
                             ids=["f32", "bf16", "mixed"])
    @pytest.mark.parametrize("wname", ["ring", "random"])
    @pytest.mark.parametrize("mask", ["none", "dead", "empty-group",
                                      "all-alive"])
    def test_mix_disp_card_path_is_the_plain_version(self, monkeypatch, mask,
                                                     wname, codes, m):
        _, mix = _card_events(monkeypatch)
        alive = _event_masks(m)[mask]
        cpu = torch.device("cpu")
        x, _, _, _, cd = cc.make_inputs(cpu, m, 257, "sgd", codes, seed=m)
        W = cc.mixing_matrix(wname, m, cpu)
        want = pref.mix_disp_ref(x, W, codes=cd, alive=alive)
        xk, n0 = x.clone(), pad.mix_disp.launches
        got = mix(xk, W, codes=cd, alive=alive)
        assert pad.mix_disp.launches == n0 + 1
        assert (got[0] is xk) == (alive is not None)
        _held_event(got, want, x, alive)


def _coded_loss(p, b, r):
    """Least squares on a bf16 weight and an f32 bias: every column of
    the plane but the bias's carries the bf16 rounding code."""
    res = b["x"] @ p["w"].float() + p["b"][0] - b["y"]
    return 0.5 * torch.mean(res * res), {}


class TestCodedEventsOnCpu:
    """The engine's rare events on a coded plane take ``avg_disp`` /
    ``mix_disp`` with the codes — here their card paths over the
    emulated kernels — one launch an event, bitwise the plain versions
    (``kernel_impl="ref"``), with and without a fault plan."""

    @pytest.mark.parametrize("plan", [None, _PLAN], ids=["no-plan", "plan"])
    @pytest.mark.parametrize("sname", ["periodic", "hierarchical", "ring"])
    def test_coded_events_launch_their_kernels(self, monkeypatch, sname,
                                               plan):
        from repro_torch.core import engine as engine_mod
        avg, mix = _card_events(monkeypatch)
        monkeypatch.setitem(engine_mod._KERNEL_OPS, "avg_disp", avg)
        monkeypatch.setitem(engine_mod._KERNEL_OPS, "mix_disp", mix)
        sched = SCHEDS["periodic" if sname == "ring" else sname]
        topo = ptopo.Topology.ring(WORKERS) if sname == "ring" else None
        out = {}
        for impl in ("auto", "ref"):
            faults = (None if plan is None else
                      pf.FaultPlan.parse(plan, WORKERS, straggle_prob=0.1))
            eng = PhaseEngine(_coded_loss, popt.Momentum(lr=0.01, mu=0.9),
                              AveragingSchedule(**sched), device="cpu",
                              faults=faults, topology=topo,
                              kernel_impl=impl)
            params = {"w": torch.zeros(DIM, dtype=torch.bfloat16),
                      "b": torch.zeros(1)}
            n0 = (pad.avg_disp.launches, pad.mix_disp.launches)
            f, h, st = eng.run(params, iter(_batches()), num_workers=WORKERS,
                               seed=3, record_every=1, return_state=True)
            out[impl] = (f, h, st, (pad.avg_disp.launches - n0[0],
                                    pad.mix_disp.launches - n0[1]))
        (f, h, st, launched), (fr, hr, sr, none) = out["auto"], out["ref"]
        assert st.codes is not None and bool((st.codes == 1.0).any())
        events = h["averages"]
        assert events > 0 and none == (0, 0)
        assert launched == ((0, events) if sname == "ring" else (events, 0))
        assert torch.equal(st.plane, sr.plane)
        assert h["loss"] == hr["loss"] and h["dispersion"] == hr[
            "dispersion"]
        assert all(torch.equal(a, b) for a, b in zip(f.values(),
                                                     fr.values()))


def _emulated_avg_disp_outer_cu(plane, prev, vel, codes, out, new_avg,
                                new_vel, dpart, disp, *, lr, momentum,
                                nesterov):
    """``avg_disp_outer_launch`` in torch on CPU tensors, column by
    column as the kernel computes: the rows summed in order and divided
    once, the dispersion against that unrounded mean, the mean rounded
    through the code before g = prev - avg, the momentum step, the new
    average rounded before it is written and broadcast, vel' f32."""
    m = plane.shape[0]
    u = {i: plane[i].clone() for i in range(m)}
    disp.copy_(_masked_disp(u, list(range(m))))
    s = torch.zeros_like(plane[0])
    for i in range(m):
        s += u[i]
    avg = s / torch.tensor(float(m))
    if codes is not None:
        avg = pref.round_to_codes(avg, codes)
    g = prev - avg
    v = momentum * vel + g
    upd = prev - lr * (momentum * v + g if nesterov else v)
    if codes is not None:
        upd = pref.round_to_codes(upd, codes)
    new_avg.copy_(upd)
    new_vel.copy_(v)
    out.copy_(upd[None].expand(m, -1))
    return 0


def _card_outer(monkeypatch):
    """``avg_disp_outer``'s card path on CPU tensors, its ctypes caller
    replaced by the emulation above (the wrapper's signature)."""
    monkeypatch.setattr(pad, "_outer_launch", _emulated_avg_disp_outer_cu)

    def outer(plane, prev, vel, *, lr, momentum, nesterov=True, codes=None):
        return pad._card_outer(plane, prev, vel, codes=codes, lr=lr,
                               momentum=momentum, nesterov=nesterov)
    return outer


class TestCodedOuterOnCpu:
    """The coded outer step through ``avg_disp_outer``'s card path (the
    codes row checked and passed, one launch a call), the kernel's column
    pass emulated: bitwise ``avg_disp_outer_ref(codes=)``; and the
    engine's coded outer event reaches that path, never the plain
    version."""

    @pytest.mark.parametrize("m", [4, 8, 24])
    @pytest.mark.parametrize("codes", ["bf16", "f16", "mixed"])
    @pytest.mark.parametrize("nesterov", [True, False])
    def test_card_path_is_the_plain_version(self, monkeypatch, nesterov,
                                            codes, m):
        outer = _card_outer(monkeypatch)
        cpu = torch.device("cpu")
        x, prev, vel, cd = cc.outer_inputs(
            cpu, m, 257, None if codes == "f16" else codes, seed=m)
        if codes == "f16":
            cd = torch.full((257,), 2.0)
            x, prev = x.half().float(), prev.half().float()
        kw = dict(lr=0.7, momentum=0.5, nesterov=nesterov, codes=cd)
        want = pref.avg_disp_outer_ref(x, prev, vel, **kw)
        n0 = pad.avg_disp_outer.launches
        got = outer(x, prev, vel, **kw)
        assert pad.avg_disp_outer.launches == n0 + 1
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        np.testing.assert_allclose(float(got[3]), float(want[3]),
                                   rtol=1e-5)
        # the rounding is there: the new average sits on the codes' grid
        assert torch.equal(got[1], pref.round_to_codes(got[1], cd))
        assert not torch.equal(got[2], pref.round_to_codes(got[2], cd))

    @pytest.mark.parametrize("sname", ["periodic", "minibatch"])
    def test_engine_outer_event_launches_the_kernel(self, monkeypatch,
                                                    sname):
        from repro_torch.core import engine as engine_mod

        def run(impl):
            eng = PhaseEngine(_coded_loss, popt.Momentum(lr=0.01, mu=0.9),
                              AveragingSchedule(**SCHEDS[sname]),
                              device="cpu", kernel_impl=impl,
                              outer=OuterOptimizer(lr=1.0, momentum=0.5))
            params = {"w": torch.zeros(DIM, dtype=torch.bfloat16),
                      "b": torch.zeros(1)}
            return eng.run(params, iter(_batches()), num_workers=WORKERS,
                           seed=3, record_every=1, return_state=True)

        fr, hr, sr = run("ref")

        def refused(*a, **k):
            raise AssertionError("the plain avg_disp_outer_ref ran")

        monkeypatch.setitem(engine_mod._KERNEL_OPS, "avg_disp_outer",
                            _card_outer(monkeypatch))
        monkeypatch.setitem(engine_mod._PLAIN_OPS, "avg_disp_outer",
                            refused)
        monkeypatch.setattr(engine_mod, "avg_disp_outer_ref", refused)
        n0 = pad.avg_disp_outer.launches
        f, h, st = run("auto")
        assert st.codes is not None and bool((st.codes == 1.0).any())
        assert h["averages"] > 0
        assert pad.avg_disp_outer.launches - n0 == h["averages"]
        assert torch.equal(st.plane, sr.plane)
        assert all(torch.equal(a, b) for a, b in zip(st.outer_state,
                                                     sr.outer_state))
        assert h["loss"] == hr["loss"]
        # minibatch reports the outer pass's dispersion: the kernel's
        # partial sums, held as card_check holds them (rtol 1e-5)
        assert [t for t, _ in h["dispersion"]] == [t for t, _ in
                                                   hr["dispersion"]]
        np.testing.assert_allclose([d for _, d in h["dispersion"]],
                                   [d for _, d in hr["dispersion"]],
                                   rtol=1e-5)
        assert all(torch.equal(a, b) for a, b in zip(f.values(),
                                                     fr.values()))


class TestRowBits:
    """``_build.row_bits``: the row word the masked kernels take."""

    def test_bit_i_is_row_i(self):
        assert _build.row_bits("t", [1, 0, 1, 1], 4) == 0b1101
        assert _build.row_bits("t", np.float32([0, 0, 0, 1, 0]), 5) == 8
        assert _build.row_bits("t", torch.tensor([1.0, 0.0]), 2) == 1
        assert _build.row_bits("t", np.zeros(3), 3) == 0

    def test_sixty_four_rows(self):
        assert _build.row_bits("t", np.ones(64), 64) == 2 ** 64 - 1
        last = np.zeros(64)
        last[63] = 1.0
        assert _build.row_bits("t", last, 64) == 1 << 63

    @pytest.mark.parametrize("mask,m", [([1, 0.5, 1], 3), ([1, 2, 0], 3),
                                        ([1, -1], 2), ([1, 1, 1], 4),
                                        (np.ones(65), 65)])
    def test_refuses_other_values_lengths_and_rows(self, mask, m):
        with pytest.raises(ValueError):
            _build.row_bits("t", mask, m)


# ---- the engine -------------------------------------------------------------

def _batches(steps=STEPS, m=WORKERS):
    X, y, _ = convex_dataset("ls", 1024, DIM, sparsity=0.2, noise=0.1,
                             seed=0)
    idx = np.random.default_rng(0).integers(0, 1024, (steps, m, 8))
    return [{"x": X[idx[t]], "y": y[idx[t]]} for t in range(steps)]


def _jloss(p, b, r):
    res = b["x"] @ p["w"].astype(jnp.float32) - b["y"]
    return 0.5 * jnp.mean(res * res), {}


def _ploss(p, b, r):
    res = b["x"] @ p["w"].float() - b["y"]
    return 0.5 * torch.mean(res * res), {}


SCHEDS = {
    "oneshot": dict(kind="oneshot"),
    "minibatch": dict(kind="minibatch"),
    "periodic": dict(kind="periodic", phase_len=8),
    "stochastic": dict(kind="stochastic", zeta=0.2),
    "hierarchical": dict(kind="hierarchical", inner_phase_len=4,
                         outer_phase_len=8, inner_groups=2),
    "adaptive_threshold": dict(kind="adaptive_threshold",
                               disp_threshold=0.05),
    "adaptive_budget": dict(kind="adaptive_budget", comm_budget=4,
                            budget_horizon=STEPS),
}
BF16 = jnp.bfloat16
#: a bf16 weight: every column carries a rounding code, and an update
#: XLA contracts into an FMA can move a bf16 rounding by one ulp
#: (tests/test_torch_engine.py's BF16_TOL)
BF16_TOL = dict(params=dict(rtol=2 ** -8, atol=1e-7), loss=dict(rtol=1e-4),
                disp=dict(rtol=1e-4))
#: name: (schedule, topology, wire, rejoin curriculum, straggle_aware,
#: weight dtype); the bf16 mixes use gossip matchings, whose weights 0
#: and 1/2 sum the same in any order
ENGINE_CASES = {
    **{k: (k, None, None, 0, False, np.float32) for k in SCHEDS},
    "periodic-ring": ("periodic", "ring", None, 0, False, np.float32),
    "minibatch-ring": ("minibatch", "ring", None, 0, False, np.float32),
    "periodic-int8": ("periodic", None, "int8", 0, False, np.float32),
    "minibatch-torus-int8": ("minibatch", "torus", "int8", 0, False,
                             np.float32),
    "hierarchical-curriculum": ("hierarchical", None, None, 3, False,
                                np.float32),
    "minibatch-ring-curriculum": ("minibatch", "ring", None, 3, False,
                                  np.float32),
    "threshold-aware": ("adaptive_threshold", None, None, 0, True,
                        np.float32),
    "budget-aware": ("adaptive_budget", None, None, 0, True, np.float32),
    "periodic-gossip-bf16": ("periodic", "gossip_pairs", None, 3, False,
                             BF16),
    "minibatch-bf16": ("minibatch", None, None, 0, False, BF16),
}


def _tol(name):
    return BF16_TOL if ENGINE_CASES[name][5] == BF16 else TOL


def _engines(case, plan_text=_PLAN, straggle=0.1):
    sname, topo, wire, cur, aware, _ = ENGINE_CASES[case]
    sc = dict(SCHEDS[sname], straggle_aware=aware)
    jkw, pkw = {}, {}
    if topo:
        jkw["topology"] = jtopo.Topology.build(topo, WORKERS)
        pkw["topology"] = ptopo.Topology.build(topo, WORKERS)
    if wire:
        jkw["compression"], pkw["compression"] = JComp(wire), Compression(
            wire)
    pk = dict(straggle_prob=straggle, rejoin_curriculum=cur)
    jeng = JEngine(_jloss, jopt.Momentum(lr=0.01, mu=0.9), JSched(**sc),
                   faults=jf.FaultPlan.parse(plan_text, WORKERS, **pk),
                   **jkw)
    peng = PhaseEngine(_ploss, popt.Momentum(lr=0.01, mu=0.9),
                       AveragingSchedule(**sc), device="cpu",
                       faults=pf.FaultPlan.parse(plan_text, WORKERS, **pk),
                       **pkw)
    return jeng, peng


def _run_both(case):
    jeng, peng = _engines(case)
    batches = _batches()
    params = {"w": np.zeros(DIM, ENGINE_CASES[case][5])}
    js = jeng.init(jax.tree.map(jnp.asarray, params), WORKERS, 3)
    js, jt = jeng.run_phase(js, tree_stack(
        [jax.tree.map(jnp.asarray, b) for b in batches]))
    ps = peng.init(params_from_jax(params, device="cpu"), WORKERS, 3)
    ps, pt = peng.run_phase(ps, batches)
    final, hist, rs = peng.run(params_from_jax(params, device="cpu"),
                               iter(batches), num_workers=WORKERS, seed=3,
                               record_every=1, return_state=True)
    return dict(jt=jax.tree.map(np.asarray, jt), jstate=js, pt=pt, ps=ps,
                hist=hist, final=final, rs=rs)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run_both(name)
        return cache[name]
    return get


class TestEngineFaults:
    @pytest.mark.parametrize("name", list(ENGINE_CASES))
    def test_decisions_and_events_equal(self, runs, name):
        r = runs(name)
        codes = [int(c) for c in r["jt"]["avg_code"]]
        assert r["pt"]["avg_code"] == codes
        events = [t for t, c in enumerate(codes, start=1) if c]
        assert r["hist"]["averages"] == len(events)
        assert [t for t, _ in r["hist"]["dispersion"]] == events
        if ENGINE_CASES[name][0] != "oneshot":
            assert events, "the case must average at least once"

    @pytest.mark.parametrize("name", list(ENGINE_CASES))
    def test_fault_rows_equal(self, runs, name):
        r = runs(name)
        jfault = r["jstate"].fault
        for st in (r["ps"], r["rs"]):
            np.testing.assert_array_equal(_bits(st.fault.alive),
                                          _bits(jfault.alive))
            np.testing.assert_array_equal(st.fault.staleness,
                                          np.asarray(jfault.staleness))
        assert r["ps"].fault.alive.tolist() == [1.0] * WORKERS

    @pytest.mark.parametrize("name", list(ENGINE_CASES))
    def test_traces_close(self, runs, name):
        r, tol = runs(name), _tol(name)
        np.testing.assert_allclose(r["pt"]["loss"], r["jt"]["loss"],
                                   **tol["loss"])
        np.testing.assert_allclose(r["pt"]["dispersion"],
                                   r["jt"]["dispersion"], **tol["disp"])
        np.testing.assert_allclose([v for _, v in r["hist"]["loss"]],
                                   r["jt"]["loss"], **tol["loss"])

    @pytest.mark.parametrize("name", list(ENGINE_CASES))
    def test_final_plane_and_consensus_close(self, runs, name):
        r, tol = runs(name), _tol(name)
        jplane = np.asarray(r["jstate"].worker_params["w"], np.float32)
        np.testing.assert_allclose(r["ps"].plane.numpy(), jplane,
                                   **tol["params"])
        np.testing.assert_allclose(r["rs"].plane.numpy(), jplane,
                                   **tol["params"])
        jf_alive = np.asarray(r["jstate"].fault.alive)
        plan = pf.FaultPlan.parse(_PLAN, WORKERS, rejoin_curriculum=
                                  ENGINE_CASES[name][3])
        mix = plan.mix_at(jf_alive, STEPS)
        want = np.asarray(jf.masked_mean(jnp.asarray(jplane),
                                         jnp.asarray(mix)))
        np.testing.assert_allclose(r["final"]["w"].float().numpy(), want,
                                   **tol["params"])

    @pytest.mark.parametrize("sname", list(SCHEDS))
    def test_all_alive_plan_is_the_no_fault_engine(self, sname):
        batches = _batches()
        out = []
        for plan in (None, pf.FaultPlan(WORKERS)):
            eng = PhaseEngine(_ploss, popt.Momentum(lr=0.01, mu=0.9),
                              AveragingSchedule(**SCHEDS[sname]),
                              device="cpu", faults=plan)
            out.append(eng.run({"w": torch.zeros(DIM)}, iter(batches),
                               num_workers=WORKERS, seed=3, record_every=1,
                               return_state=True))
        (f0, h0, s0), (f1, h1, s1) = out
        assert torch.equal(f0["w"], f1["w"]) and torch.equal(s0.plane,
                                                             s1.plane)
        assert h0["loss"] == h1["loss"] and h0["dispersion"] == h1[
            "dispersion"] and h0["averages"] == h1["averages"]

    @pytest.mark.parametrize("name", ["periodic", "stochastic",
                                      "adaptive_threshold", "periodic-int8",
                                      "hierarchical-curriculum"])
    def test_run_host_is_run_bitwise(self, name):
        _, peng = _engines(name)
        batches = _batches()
        kw = dict(num_workers=WORKERS, seed=3, record_every=1)
        f, h = peng.run({"w": torch.zeros(DIM)}, iter(batches), **kw)
        fh, hh = peng.run_host({"w": torch.zeros(DIM)}, iter(batches), **kw)
        assert torch.equal(f["w"], fh["w"])
        assert h["loss"] == hh["loss"] and h["dispersion"] == hh[
            "dispersion"]
        assert len(hh["phase_wall"]) == STEPS

    def test_dead_rows_frozen_and_rejoin_warm_starts(self):
        eng = PhaseEngine(_ploss, popt.Momentum(lr=0.01, mu=0.9),
                          AveragingSchedule("oneshot"), device="cpu",
                          faults=pf.FaultPlan.parse(_PLAN, WORKERS))
        batches = _batches()

        def state(k):
            return eng.run({"w": torch.zeros(DIM)}, iter(batches[:k]),
                           num_workers=WORKERS, seed=0,
                           return_state=True)[2]
        st5, st13, st14 = state(5), state(13), state(14)
        assert torch.equal(st13.plane[1], st5.plane[1])
        assert torch.equal(st13.opt_planes[0][1], st5.opt_planes[0][1])
        assert st13.fault.alive.tolist() == [1.0, 0.0, 1.0, 1.0]
        assert st13.fault.staleness[1] == 8
        assert not torch.equal(st14.plane[1], st5.plane[1])
        assert st14.fault.alive.tolist() == [1.0] * WORKERS
        # the rejoiner started step 14 from the cohort mean, momentum 0:
        # its update is one plain gradient step away from that mean
        mean = pf.masked_mean(st13.plane, [1.0, 0.0, 1.0, 1.0])
        assert float((st14.plane[1] - mean).abs().max()) < 0.05
        torch.testing.assert_close(mean - st14.plane[1],
                                   0.01 * st14.opt_planes[0][1],
                                   rtol=1e-5, atol=1e-7)

    def test_straggler_only_plan_runs_and_differs(self):
        batches = _batches()

        def run(plan):
            eng = PhaseEngine(_ploss, popt.SGD(0.05),
                              AveragingSchedule("periodic", phase_len=8),
                              device="cpu", faults=plan)
            return eng.run({"w": torch.zeros(DIM)}, iter(batches),
                           num_workers=WORKERS, seed=0)[0]["w"]
        f0 = run(None)
        f1, f2 = run(pf.FaultPlan(WORKERS, (), 0.5)), run(
            pf.FaultPlan(WORKERS, (), 0.5))
        assert torch.equal(f1, f2) and not torch.equal(f0, f1)
