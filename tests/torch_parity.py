"""Two-way parity helpers of the port's tests: one run's results in the
JAX reference and in the port, held at the north star's tolerances
(ROADMAP.md): decisions, event steps and ``averages`` equal; params and
losses within rtol 1e-6 / atol 1e-7 (loss traces by ``allclose``: R1);
dispersions within rtol 1e-5."""
import numpy as np
import torch

from repro_torch.core.flat import tree_flatten

TOL = dict(params=dict(rtol=1e-6, atol=1e-7),
           loss=dict(rtol=1e-6, atol=1e-7), disp=dict(rtol=1e-5))


def leaves_np(tree) -> list:
    """The leaves of a port (torch) or reference (jax) tree as float64
    numpy arrays, in ``jax.tree.flatten`` order."""
    out = []
    for x in tree_flatten(tree)[0] if _is_torch(tree) else _jax_leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        out.append(np.asarray(x, np.float64))
    return out


def _is_torch(tree) -> bool:
    leaves = tree_flatten(tree)[0]
    return bool(leaves) and isinstance(leaves[0], torch.Tensor)


def _jax_leaves(tree) -> list:
    import jax
    return jax.tree.leaves(tree)


def assert_trees_close(got, want, tol=TOL["params"]):
    a, b = leaves_np(got), leaves_np(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **tol)


def assert_histories_match(got: dict, want: dict, tol=TOL):
    """A port history against a reference one: ``averages``, the event
    steps, the recorded steps and (where both have them) ``resizes``
    equal; the loss and dispersion values allclose."""
    assert got["averages"] == want["averages"]
    for key in ("dispersion", "loss", "disp_trace"):
        assert [t for t, _ in got[key]] == [t for t, _ in want[key]], key
    if "resizes" in want:
        assert got["resizes"] == [tuple(r) for r in want["resizes"]]
    for key, k in (("loss", "loss"), ("dispersion", "disp"),
                   ("disp_trace", "disp")):
        if got[key]:
            np.testing.assert_allclose([v for _, v in got[key]],
                                       [float(v) for _, v in want[key]],
                                       **tol[k])


def assert_runs_match(got, want, tol=TOL):
    """(final params, history) of the port against the reference's."""
    assert_histories_match(got[1], want[1], tol)
    assert_trees_close(got[0], want[0], tol["params"])
