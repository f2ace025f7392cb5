"""``repro_torch.launch.steps``' training steps against the JAX
reference's ``repro.launch.steps``, on the CPU, at reduced smollm-360m
(two layers, d_model 256, float32) with the reference's params carried
over as numpy and the same token draws:

- ``make_optimizer`` is the reference's Momentum(0.01, 0.9);
- ``make_train_step`` (with and without the average, flat or
  hierarchical) and ``make_phase_step`` (flat-native, flat with an
  optimizer without the plane protocol, tree; avg all / inner / none)
  against the reference's: the mean losses within rtol 1e-5 and the
  params and optimizer state within rtol 1e-5 / atol 1e-6
  (``tests/test_torch_models.py``'s loss tolerance; the gradients of two
  float32 transformers part in their last bits);
- inside the port, bit for bit: ``remat`` on and off, and the
  flat-native phase step against two train steps and the average;
- ``impl="kernel"`` training is refused: the kernels are forward-only,
  as the reference's Pallas kernels are.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import reduced_f32  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch import optim as popt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import average_all, replicate  # noqa: E402
from repro_torch.core.flat import tree_flatten, tree_map  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

M, B, S, K = 4, 1, 8, 2
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, numpy params, token blocks (K, M, B, S))."""
    import dataclasses
    jcfg = reduced_f32("smollm-360m")
    pcfg = dataclasses.replace(
        port_configs.get_config("smollm-360m", reduced=True),
        dtype="float32")
    params = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (K, M, B, S)).astype(np.int32)
    return jcfg, pcfg, params, toks


def _port_workers(params, opt):
    wp = replicate(params_from_jax(params, device="cpu"), M)
    return wp, opt.init(wp)


def _jax_workers(params, opt):
    wp = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (M,) + x.shape),
                      jax.tree.map(jnp.asarray, params))
    return wp, jax.vmap(opt.init)(wp)


def _close(got, want, tol=PARAM_TOL):
    a = [x.detach().float().numpy() for x in tree_flatten(got)[0]]
    b = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **tol)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[0],
                                                 tree_flatten(b)[0]))


def test_make_optimizer_is_the_reference_recipe():
    o, j = steps.make_optimizer(), jsteps.make_optimizer()
    assert isinstance(o, popt.Momentum)
    assert (o.lr, o.mu, o.nesterov) == (j.lr, j.mu, j.nesterov)


@pytest.mark.parametrize("do_avg,inner", [(False, 0), (True, 0),
                                          (True, 2)])
def test_train_step_matches_reference(model, do_avg, inner):
    jcfg, pcfg, params, toks = model
    pstep = steps.make_train_step(pcfg, do_avg=do_avg, inner_groups=inner)
    jstep = jsteps.make_train_step(jcfg, do_avg=do_avg, inner_groups=inner)
    wp, os_ = _port_workers(params, steps.make_optimizer())
    jwp, jos = _jax_workers(params, jsteps.make_optimizer())
    for k in range(K):
        wp, os_, loss = pstep(wp, os_, {"tokens": torch.from_numpy(
            toks[k]).long()}, k + 1)
        jwp, jos, jloss = jstep(jwp, jos, {"tokens": jnp.asarray(toks[k])},
                                jnp.asarray(k + 1, jnp.int32))
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    _close(wp, jwp)
    _close(os_, jos)


class _TreeMomentum:
    """Momentum's tree half alone (no plane protocol): the phase step's
    flat branch unpacks around it."""
    def __init__(self, lr, mu, jax_side=False):
        self._m = (jopt.Momentum if jax_side else popt.Momentum)(lr, mu)

    def init(self, params):
        return self._m.init(params)

    def apply(self, params, grads, state, step):
        return self._m.apply(params, grads, state, step)


PHASES = {
    "native-all": dict(flat=True, avg="all"),
    "native-inner": dict(flat=True, avg="inner", inner_groups=2),
    "flat-all": dict(flat=True, avg="all", tree_opt=True),
    "tree-all": dict(flat=False, avg="all"),
    "tree-inner": dict(flat=False, avg="inner", inner_groups=2),
    "tree-none": dict(flat=False, avg="none"),
}


@pytest.mark.parametrize("name", list(PHASES))
def test_phase_step_matches_reference(model, name):
    jcfg, pcfg, params, toks = model
    kw = dict(PHASES[name])
    tree_opt = kw.pop("tree_opt", False)
    popt_ = _TreeMomentum(0.01, 0.9) if tree_opt else steps.make_optimizer()
    jopt_ = (_TreeMomentum(0.01, 0.9, jax_side=True) if tree_opt
             else jsteps.make_optimizer())
    pphase = steps.make_phase_step(pcfg, phase_len=K, optimizer=popt_, **kw)
    jphase = jsteps.make_phase_step(jcfg, phase_len=K, optimizer=jopt_,
                                    **kw)
    wp, os_ = _port_workers(params, popt_)
    jwp, jos = _jax_workers(params, jopt_)
    wp, os_, losses = pphase(wp, os_, {"tokens": torch.from_numpy(
        toks).long()}, 3)
    jwp, jos, jlosses = jphase(jwp, jos, {"tokens": jnp.asarray(toks)},
                               jnp.asarray(3, jnp.int32))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    _close(wp, jwp)
    _close(os_, jos)


def test_remat_is_bitwise_and_phase_equals_train_steps(model):
    """``remat`` on and off: the same losses, params and state bit for
    bit, through the train step and the flat-native phase step; the
    phase step equals two train steps and the average bit for bit."""
    _, pcfg, params, toks = model
    batches = {"tokens": torch.from_numpy(toks).long()}
    out = {}
    for remat in (False, True):
        phase = steps.make_phase_step(pcfg, phase_len=K, remat=remat,
                                      flat=True)
        wp, os_ = _port_workers(params, steps.make_optimizer())
        out[("phase", remat)] = phase(wp, os_, batches, 0)
        train = steps.make_train_step(pcfg, remat=remat)
        wp, os_ = _port_workers(params, steps.make_optimizer())
        losses = []
        for k in range(K):
            wp, os_, loss = train(wp, os_, tree_map(lambda x: x[k],
                                                    batches), k + 1)
            losses.append(loss)
        out[("train", remat)] = (average_all(wp), os_, torch.stack(losses))
    for kind in ("phase", "train"):
        a, b = out[(kind, False)], out[(kind, True)]
        assert _equal(a[0], b[0]) and _equal(a[1], b[1])
        assert torch.equal(a[2], b[2])
    p, t = out[("phase", True)], out[("train", True)]
    assert _equal(p[0], t[0]) and _equal(p[1], t[1])
    assert torch.equal(p[2], t[2])


def test_kernel_training_is_refused(model):
    _, pcfg, params, toks = model
    step = steps.make_train_step(pcfg, impl="kernel")
    wp, os_ = _port_workers(params, steps.make_optimizer())
    with pytest.raises(NotImplementedError, match="forward-only"):
        step(wp, os_, {"tokens": torch.from_numpy(toks[0]).long()}, 1)
    with pytest.raises(ValueError, match="avg must be one of"):
        steps.make_phase_step(pcfg, phase_len=K, avg="some")
