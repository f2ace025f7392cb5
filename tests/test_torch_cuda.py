"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; every test skips without a CUDA device (decided
in a fixture, so every worker collects the same tests). Needs no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

``--noconftest`` because tests/conftest.py imports JAX, which a GPU host
that runs only the port need not have.

The shapes, inputs and criteria are ``repro_torch.kernels.card_check``'s,
the same that ``chip_smoke.py`` runs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import card_check as cc  # noqa: E402
from repro_torch.kernels.avg_disp import (avg_disp,  # noqa: E402
                                          avg_disp_outer, compressed_mix,
                                          mix_disp)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.opt_step import opt_step  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", cc.SHAPES, ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("codes", [None, "mixed"], ids=["f32", "codes"])
@pytest.mark.parametrize("mode", ["none", "mean", "group"])
@pytest.mark.parametrize("opt", list(cc.OPTS))
def test_opt_step_kernel_matches_plain(dev, opt, mode, codes, shape):
    m, p, groups = shape
    kind, hyp = cc.OPTS[opt]
    x, g, st, scal, cd = cc.make_inputs(dev, m, p, kind, codes)
    n0 = opt_step.launches
    cc.check_opt_step(opt, x, g, st, scal, cd, kind=kind, mode=mode,
                      groups=groups if mode == "group" else 1, **hyp)
    assert opt_step.launches == n0 + 2


@pytest.mark.parametrize("shape", cc.SHAPES, ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("groups", cc.AVG_GROUPS)
def test_avg_disp_kernel_matches_plain(dev, groups, shape):
    m, p, _ = shape
    x = cc.make_inputs(dev, m, p, "sgd", seed=groups)[0]
    n0 = avg_disp.launches
    cc.check_avg_disp(f"g{groups}", x, groups)
    assert avg_disp.launches == n0 + 2


@pytest.mark.parametrize("shape", cc.SHAPES, ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("codes", ["bf16", "mixed"])
@pytest.mark.parametrize("groups", cc.AVG_GROUPS)
def test_avg_disp_kernel_with_codes_matches_plain(dev, groups, codes, shape):
    """avg_disp.cu's CODES instantiation: bitwise plane_average_ref."""
    m, p, _ = shape
    x, _, _, _, cd = cc.make_inputs(dev, m, p, "sgd", codes, seed=groups)
    n0 = avg_disp.launches
    cc.check_avg_disp(f"g{groups}-{codes}", x, groups, cd)
    assert avg_disp.launches == n0 + 2


@pytest.mark.parametrize("shape", cc.NARROW_SHAPES,
                         ids=lambda s: f"M{s[0]}P{s[1]}")
@pytest.mark.parametrize("codes", [None, "mixed"], ids=["f32", "codes"])
@pytest.mark.parametrize("mode", ["none", "mean"])
@pytest.mark.parametrize("opt", list(cc.OPTS))
def test_opt_step_kernel_on_narrow_planes(dev, opt, mode, codes, shape):
    """One worker, and a plane narrower than one column block: bitwise."""
    n0 = opt_step.launches
    assert cc.check_narrow_opt_step(dev, *shape, opt, mode, codes) == 0.0
    assert opt_step.launches == n0 + 2


@pytest.mark.parametrize("shape", cc.NARROW_SHAPES,
                         ids=lambda s: f"M{s[0]}P{s[1]}")
def test_avg_disp_kernel_on_narrow_planes(dev, shape):
    m, p = shape
    for groups in cc.AVG_GROUPS:
        if m % groups == 0:
            x = cc.make_inputs(dev, m, p, "sgd", seed=groups)[0]
            assert cc.check_avg_disp(f"g{groups}", x, groups) == 0.0


@pytest.mark.parametrize("masked", [False, True], ids=["all", "dead"])
@pytest.mark.parametrize("codes", [None, "mixed"], ids=["f32", "codes"])
@pytest.mark.parametrize("shape", cc.AVG_WIDTH_SHAPES + [cc.CNN_PLANE],
                         ids=lambda s: f"M{s[0]}P{s[1]}")
def test_avg_disp_one_launch_design(dev, shape, codes, masked):
    """avg_disp.cu's columns a thread, ragged and narrow planes and the
    CNN's: bitwise the plain version, one launch a call, the ticket back
    at 0, a grid within the plane's tiles (card_check.check_avg_event)."""
    m, p = shape
    alive = cc.fault_masks(m)["dead"][0] if masked else None
    x, _, _, _, cd = cc.make_inputs(dev, m, p, "sgd", codes, seed=p % 97)
    for groups in cc.AVG_GROUPS:
        e, _ = cc.check_avg_event(f"g{groups}", x, groups, cd, alive)
        assert e == 0.0


@pytest.mark.parametrize("m", cc.AVG_SPAN_M)
def test_avg_disp_at_the_persistent_grid_span(dev, m):
    """P at the persistent grid's column span and one either side: the
    last thread sweeps one column more, or one column less."""
    for mm, p in cc.avg_span_shapes(dev, m):
        x = cc.make_inputs(dev, mm, p, "sgd", seed=p % 89)[0]
        for groups in cc.AVG_GROUPS:
            e, _ = cc.check_avg_event(f"g{groups}-P{p}", x, groups)
            assert e == 0.0


def test_avg_disp_scratch_per_stream(dev):
    """The cached scratch: calls of different P back to back, a masked
    call after an unmasked one, calls on a side stream beside the default
    stream's."""
    assert cc.check_avg_scratch(dev) == 10


def test_kernels_refuse_what_they_cannot_take(dev):
    x, g, st, scal, _ = cc.make_inputs(dev, 4, 64, "momentum")
    with pytest.raises(ValueError, match="contiguous"):
        opt_step(x.t().contiguous().t(), g, st, scal, kind="momentum")
    with pytest.raises(ValueError):
        opt_step(x, g.double(), st, scal, kind="momentum")
    with pytest.raises(ValueError, match="1..64"):
        avg_disp(torch.zeros(65, 8, device=dev))


COMM_IDS = lambda s: f"M{s[0]}P{s[1]}"  # noqa: E731


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
@pytest.mark.parametrize("wname", cc.MIXES)
def test_mix_disp_kernel_matches_plain(dev, wname, shape):
    m, p, _ = shape
    x = cc.make_inputs(dev, m, p, "sgd", seed=m)[0]
    n0 = mix_disp.launches
    cc.check_mix_disp(wname, x, cc.mixing_matrix(wname, m, dev))
    assert mix_disp.launches == n0 + 2


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
@pytest.mark.parametrize("codes", ["bf16", "mixed"])
@pytest.mark.parametrize("wname", cc.MIXES)
def test_mix_disp_kernel_with_codes_matches_plain(dev, wname, codes, shape):
    """mix_disp.cu's CODES instantiation: bitwise mix_disp_ref."""
    m, p, _ = shape
    x, _, _, _, cd = cc.make_inputs(dev, m, p, "sgd", codes, seed=m)
    n0 = mix_disp.launches
    cc.check_mix_disp(f"{wname}-{codes}", x,
                      cc.mixing_matrix(wname, m, dev), cd)
    assert mix_disp.launches == n0 + 2


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
@pytest.mark.parametrize("codes", [None, "mixed"], ids=["f32", "codes"])
@pytest.mark.parametrize("wname", cc.MIXES)
@pytest.mark.parametrize("opt", list(cc.OPTS))
def test_opt_step_mix_kernel_matches_plain(dev, opt, wname, codes, shape):
    m, p, _ = shape
    kind, hyp = cc.OPTS[opt]
    x, g, st, scal, cd = cc.make_inputs(dev, m, p, kind, codes)
    n0 = opt_step.launches
    cc.check_opt_step(opt, x, g, st, scal, cd, kind=kind, mode="mix",
                      W=cc.mixing_matrix(wname, m, dev), **hyp)
    assert opt_step.launches == n0 + 2


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
@pytest.mark.parametrize("codes", list(cc.CODE_KINDS),
                         ids=["f32", "bf16", "mixed"])
@pytest.mark.parametrize("nesterov", [True, False])
def test_avg_disp_outer_kernel_matches_plain(dev, nesterov, codes, shape):
    """The outer step bitwise its plain version, the coded one (the
    ``CODES`` instantiation) too: one launch a call."""
    m, p, _ = shape
    x, prev, vel, cd = cc.outer_inputs(dev, m, p, codes, seed=m)
    n0 = avg_disp_outer.launches
    cc.check_avg_disp_outer("outer", x, prev, vel, cd, lr=0.7, momentum=0.5,
                            nesterov=nesterov)
    assert avg_disp_outer.launches == n0 + 2


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
@pytest.mark.parametrize("ef", [True, False], ids=["ef", "no-ef"])
@pytest.mark.parametrize("codes", [None, "mixed"], ids=["f32", "codes"])
@pytest.mark.parametrize("mode", ["mean", "group", "mix"])
@pytest.mark.parametrize("wire", cc.WIRES)
def test_compressed_kernels_match_plain(dev, wire, mode, codes, ef, shape):
    """``compressed_mix`` and the ``opt_step`` wire path on one case; the
    wire path's event is a ``compressed_mix.cu`` launch and counts as
    one."""
    m, p, groups = shape
    x, g, st, scal, cd = cc.make_inputs(dev, m, p, "momentum", codes)
    r, u = cc.wire_inputs(dev, m, p, seed=m)
    kw = dict(wire=wire, mode=mode, groups=groups if mode == "group" else 1,
              W=cc.mixing_matrix("ring", m, dev) if mode == "mix" else None,
              error_feedback=ef)
    uu = u if wire == "int8" else None
    n0, o0 = compressed_mix.launches, opt_step.launches
    cc.check_compressed("compressed_mix", x, r, u=uu, codes=cd, **kw)
    cc.check_opt_step_wire("opt_step/wire", x, g, st, scal, cd, r, uu,
                           kind="momentum", mu=0.9, **kw)
    assert compressed_mix.launches == n0 + 4
    assert opt_step.launches == o0 + 2


def test_comm_kernels_refuse_what_they_cannot_take(dev):
    x = torch.zeros(4, 64, device=dev)
    W = torch.eye(4, device=dev)
    with pytest.raises(ValueError, match="W"):
        mix_disp(x, W.double())
    with pytest.raises(ValueError, match="W"):
        mix_disp(x, W.cpu())
    with pytest.raises(ValueError, match="prev_avg"):
        avg_disp_outer(x, torch.zeros(64), torch.zeros(64, device=dev),
                       lr=1.0, momentum=0.5)
    with pytest.raises(ValueError, match="resid"):
        compressed_mix(x, torch.zeros(4, 64, device=dev).t().contiguous()
                       .t(), wire="bf16")
    with pytest.raises(ValueError, match="u"):
        compressed_mix(x, x.clone(), wire="int8",
                       u=torch.zeros(4, 64, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="1..64"):
        mix_disp(torch.zeros(65, 8, device=dev),
                 torch.eye(65, device=dev))


def test_engine_gossip_int8_on_card_matches_cpu(dev):
    """The least squares under gossip_pairs + int8, periodic K=4, on the
    card and on the CPU: the same decisions, matchings and uniforms, so
    the same event steps; losses within rtol 1e-4, params within rtol
    1e-4 but for entries an int8 floor put one quantum apart where the
    two devices' gradients differ in the last bit, counted and bounded
    (``card_check.count_quantum_flips``)."""
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.core.compress import Compression
    from repro_torch.optim import Momentum
    from repro_torch.topology import Topology

    rng = np.random.default_rng(0)
    X = rng.standard_normal((512, 64)).astype(np.float32)
    y = (X @ rng.standard_normal(64)).astype(np.float32)
    idx = rng.integers(0, 512, (16, 8, 4))
    batches = [{"x": X[idx[t]], "y": y[idx[t]]} for t in range(16)]

    def loss(p, b, r):
        res = b["x"] @ p["w"] - b["y"]
        return 0.5 * torch.mean(res * res), {}

    def run(device):
        eng = PhaseEngine(loss, Momentum(lr=0.01, mu=0.9),
                          AveragingSchedule("periodic", phase_len=4),
                          device=device, topology=Topology.gossip_pairs(8),
                          compression=Compression("int8"))
        return eng.run({"w": torch.zeros(64)}, iter(batches),
                       num_workers=8, seed=1, record_every=1,
                       return_state=True)

    n0 = compressed_mix.launches
    (_, hg, sg), (_, hc, sc) = run("cuda"), run("cpu")
    assert compressed_mix.launches == n0 + 4
    assert [t for t, _ in hg["dispersion"]] == [t for t, _ in
                                                hc["dispersion"]]
    np.testing.assert_allclose([v for _, v in hg["loss"]],
                               [v for _, v in hc["loss"]], rtol=1e-4)
    cc.count_quantum_flips(sg.plane.cpu(), sc.plane, rtol=1e-4, atol=1e-6)


def test_engine_on_card_matches_cpu(dev):
    from repro_torch.configs import get_config
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.data import token_stream
    from repro_torch.models import init_params, lm_loss
    from repro_torch.optim import Momentum

    cfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                              dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    streams = [token_stream(cfg.vocab_size, 2, 16, seed=i) for i in range(4)]
    batches = [{"tokens": np.stack([next(s) for s in streams])}
               for _ in range(4)]

    def run(device):
        eng = PhaseEngine(lambda p, b, r: lm_loss(cfg, p, b),
                          Momentum(lr=0.01, mu=0.9),
                          AveragingSchedule("periodic", phase_len=2),
                          device=device)
        return eng.run(params, iter(batches), num_workers=4, seed=0,
                       record_every=1)

    n0 = opt_step.launches
    (fg, hg), (fc, hc) = run("cuda"), run("cpu")
    assert opt_step.launches == n0 + 4
    assert hg["averages"] == hc["averages"] == 2
    np.testing.assert_allclose([v for _, v in hg["loss"]],
                               [v for _, v in hc["loss"]], rtol=1e-4)
    for a, b in zip(torch.utils._pytree.tree_leaves(fg),
                    torch.utils._pytree.tree_leaves(fc)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)


def test_engine_indexed_on_card_matches_cpu(dev):
    """The indexed path (a DeviceDataset's (K, M) index list, batches
    gathered on the device) on the card and on the CPU: the same event
    steps, params and losses within rtol 1e-4; on the card the indexed
    run is bitwise the staged one, ``kernel_impl="cuda"`` launches the
    kernels and ``"ref"`` launches none."""
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.data import DeviceDataset
    from repro_torch.models.convex import ls_objective
    from repro_torch.optim import SGD

    rng = np.random.default_rng(0)
    X = rng.standard_normal((512, 64)).astype(np.float32)
    y = (X @ rng.standard_normal(64)).astype(np.float32)
    idx = rng.integers(0, 512, (32, 24))

    def loss(p, b, r):
        return 0.5 * torch.square(b["x"] @ p["w"] - b["y"]), {}

    def run(device, data=None, **kw):
        eng = PhaseEngine(loss, SGD(lr=lambda t: 0.3 / (t + 20.0)),
                          AveragingSchedule("hierarchical", inner_groups=4,
                                            inner_phase_len=4,
                                            outer_phase_len=16),
                          device=device, **kw)
        if data is None:
            data = DeviceDataset({"x": X, "y": y}, 24, indices=idx,
                                 device=device)
        Xd, yd = torch.from_numpy(X).to(device), torch.from_numpy(y).to(
            device)
        return eng.run({"w": torch.zeros(64)}, data, num_workers=24,
                       seed=0, record_every=4,
                       eval_fn=lambda p: float(ls_objective(p["w"], Xd, yd)))

    n0, a0 = opt_step.launches, avg_disp.launches
    fg, hg = run("cuda", kernel_impl="cuda")
    assert (opt_step.launches - n0, avg_disp.launches - a0) == (32, 8)
    fc, hc = run("cpu")
    assert [t for t, _ in hg["dispersion"]] == [t for t, _ in
                                                hc["dispersion"]]
    assert hg["averages"] == 8
    np.testing.assert_allclose(fg["w"].cpu().numpy(), fc["w"].numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose([v for _, v in hg["loss"]],
                               [v for _, v in hc["loss"]], rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose([v for _, v in hg["eval"]],
                               [v for _, v in hc["eval"]], rtol=1e-4)
    staged = [{"x": X[idx[t]], "y": y[idx[t]]} for t in range(len(idx))]
    fs, hs = run("cuda", data=staged)
    assert torch.equal(fs["w"], fg["w"]) and hs["loss"] == hg["loss"]
    n0, a0 = opt_step.launches, avg_disp.launches
    fr, _ = run("cuda", kernel_impl="ref")
    assert (opt_step.launches, avg_disp.launches) == (n0, a0)
    np.testing.assert_allclose(fr["w"].cpu().numpy(), fg["w"].cpu().numpy(),
                               rtol=1e-4, atol=1e-6)


# ---- the fault paths (alive / umask) ----------------------------------------

FAULT_MASKS = ("dead", "straggle", "all-alive")


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
@pytest.mark.parametrize("mask", FAULT_MASKS)
def test_fault_events_match_plain(dev, mask, shape):
    """avg_disp(alive=) (groups 1 and the shape's) and mix_disp(alive=)
    over a ring, each one launch of its own kernel's masked pass a call:
    no mix_disp launch for a masked mean."""
    m, p, groups = shape
    alive, _ = cc.fault_masks(m)[mask]
    x = cc.make_inputs(dev, m, p, "sgd", seed=5)[0]
    n0, a0 = mix_disp.launches, avg_disp.launches
    for grp in (1, groups):
        cc.check_avg_disp_fault(f"g{grp}", x, alive, grp)
    assert (mix_disp.launches - n0, avg_disp.launches - a0) == (0, 4)
    cc.check_mix_disp_fault("ring", x, cc.mixing_matrix("ring", m, dev),
                            alive)
    assert (mix_disp.launches - n0, avg_disp.launches - a0) == (2, 4)


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
@pytest.mark.parametrize("mask", FAULT_MASKS)
@pytest.mark.parametrize("codes", ["bf16", "mixed"])
def test_fault_events_with_codes_match_plain(dev, codes, mask, shape):
    """The MASKED and CODES instantiations together: bitwise the plain
    versions on the alive rows, dead rows untouched."""
    m, p, groups = shape
    alive, _ = cc.fault_masks(m)[mask]
    x, _, _, _, cd = cc.make_inputs(dev, m, p, "sgd", codes, seed=6)
    for grp in (1, groups):
        cc.check_avg_disp_fault(f"g{grp}-{codes}", x, alive, grp, cd)
    cc.check_mix_disp_fault(f"ring-{codes}", x,
                            cc.mixing_matrix("ring", m, dev), alive, cd)


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
def test_avg_disp_fault_leaves_a_dead_group(dev, shape):
    """A masked group mean whose first group has no alive row: that
    group is neither read nor written."""
    m, p, groups = shape
    x, _, _, _, cd = cc.make_inputs(dev, m, p, "sgd", "mixed", seed=7)
    cc.check_avg_disp_fault("empty-group", x, cc.empty_group_mask(m, groups),
                            groups, cd)


def test_event_kernels_refuse_what_they_cannot_take(dev):
    x = torch.zeros(4, 64, device=dev)
    W = torch.eye(4, device=dev)
    for codes in (torch.zeros(64, device=dev, dtype=torch.float64),
                  torch.zeros(63, device=dev), torch.zeros(64)):
        with pytest.raises(ValueError, match="codes"):
            avg_disp(x, codes=codes)
        with pytest.raises(ValueError, match="codes"):
            mix_disp(x, W, codes=codes)
    for alive in ([1, 0.5, 1, 1], [1, 1, 1]):
        with pytest.raises(ValueError, match="row mask"):
            avg_disp(x, alive=alive)
        with pytest.raises(ValueError, match="row mask"):
            mix_disp(x, W, alive=alive)


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
@pytest.mark.parametrize("mask", FAULT_MASKS)
@pytest.mark.parametrize("mode", ["mean", "group", "mix"])
@pytest.mark.parametrize("wire", cc.WIRES)
def test_compressed_fault_matches_plain(dev, wire, mode, mask, shape):
    m, p, groups = shape
    alive, _ = cc.fault_masks(m)[mask]
    x, _, _, _, codes = cc.make_inputs(dev, m, p, "sgd", "mixed", seed=6)
    r, u = cc.wire_inputs(dev, m, p, seed=6)
    n0 = compressed_mix.launches
    cc.check_compressed_fault(
        wire, x, r, alive, wire=wire, mode=mode,
        groups=groups if mode == "group" else 1,
        W=cc.mixing_matrix("ring", m, dev) if mode == "mix" else None,
        u=u if wire == "int8" else None, codes=codes)
    assert compressed_mix.launches == n0 + 2


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
@pytest.mark.parametrize("mask", FAULT_MASKS)
@pytest.mark.parametrize("codes", [None, "mixed"], ids=["f32", "codes"])
@pytest.mark.parametrize("mode", ["none", "mean", "group", "mix"])
def test_opt_step_fault_matches_plain(dev, mode, codes, mask, shape):
    """One masked opt_step launch per call in every mode, the event in
    the kernel: no mix_disp launch."""
    m, p, groups = shape
    alive, umask = cc.fault_masks(m)[mask]
    x, g, st, scal, cd = cc.make_inputs(dev, m, p, "momentum", codes,
                                        seed=7)
    n0, x0 = opt_step.launches, mix_disp.launches
    cc.check_opt_step_fault(
        mode, x, g, st, scal, cd, alive, umask, kind="momentum", mu=0.9,
        mode=mode, groups=groups if mode == "group" else 1,
        W=cc.mixing_matrix("ring", m, dev) if mode == "mix" else None)
    assert opt_step.launches == n0 + 2
    assert mix_disp.launches == x0


@pytest.mark.parametrize("mode", ["none", "mean", "group", "mix", "wire"])
def test_opt_step_fault_solo_rows_keep_their_step(dev, mode):
    """A row in the update mask and outside the event's cohort (a
    rejoining worker's solo window) takes its step and keeps it."""
    alive = np.array([1, 0, 1, 0, 1, 1, 1, 1], np.float32)
    umask = np.array([0, 0, 1, 1, 1, 1, 1, 1], np.float32)
    x, g, st, scal, cd = cc.make_inputs(dev, 8, 5003, "momentum", "mixed",
                                        seed=12)
    r, _ = cc.wire_inputs(dev, 8, 5003, seed=12)
    mix = mode in ("mix", "wire")
    kw = dict(kind="momentum", mu=0.9, mode="mix" if mix else mode,
              groups=4 if mode == "group" else 1,
              W=cc.mixing_matrix("ring", 8, dev) if mix else None)
    if mode == "wire":
        kw.update(wire="one_bit", resid=r)
    cc.check_opt_step_fault(mode, x, g, st, scal, cd, alive, umask, **kw)


@pytest.mark.parametrize("shape", cc.COMM_SHAPES, ids=COMM_IDS)
@pytest.mark.parametrize("mask", FAULT_MASKS)
@pytest.mark.parametrize("wire", cc.WIRES)
def test_opt_step_wire_fault_matches_plain(dev, wire, mask, shape):
    m, p, _ = shape
    alive, umask = cc.fault_masks(m)[mask]
    x, g, st, scal, _ = cc.make_inputs(dev, m, p, "momentum", seed=8)
    r, u = cc.wire_inputs(dev, m, p, seed=8)
    n0, c0 = opt_step.launches, compressed_mix.launches
    cc.check_opt_step_fault(
        wire, x, g, st, scal, None, alive, umask, resid=r,
        u=u if wire == "int8" else None, kind="momentum", mu=0.9,
        mode="mix", wire=wire, W=cc.mixing_matrix("ring", m, dev))
    assert (opt_step.launches - n0, compressed_mix.launches - c0) == (2, 2)


@pytest.mark.parametrize("variant", ["periodic", "ring", "int8"])
def test_engine_faults_on_card_matches_cpu(dev, variant):
    """The least squares (24 workers) under a crash, a rejoin with a
    curriculum and stragglers, on the card and on the CPU: the same
    decisions, alive and staleness rows; params and losses within rtol
    1e-4 (int8: but for quantum flips, counted and bounded); on the card
    run and run_host bitwise equal."""
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.core.compress import Compression
    from repro_torch.data import DeviceDataset
    from repro_torch.faults import FaultPlan
    from repro_torch.optim import SGD
    from repro_torch.topology import Topology

    rng = np.random.default_rng(0)
    X = rng.standard_normal((512, 64)).astype(np.float32)
    y = (X @ rng.standard_normal(64)).astype(np.float32)
    idx = rng.integers(0, 512, (48, 24))
    plan = FaultPlan.parse("crash:m=3@t=10,crash:m=7@t=10,rejoin:m=3@t=30",
                           24, straggle_prob=0.1, rejoin_curriculum=4)
    comm = {"periodic": {}, "ring": dict(topology=Topology.ring(24)),
            "int8": dict(compression=Compression("int8"))}[variant]

    def loss(p, b, r):
        return 0.5 * torch.square(b["x"] @ p["w"] - b["y"]), {}

    def run(device, host=False):
        eng = PhaseEngine(loss, SGD(lr=lambda t: 0.3 / (t + 20.0)),
                          AveragingSchedule("periodic", phase_len=8),
                          device=device, faults=plan, **comm)
        if host:
            return eng.run_host({"w": torch.zeros(64)},
                                [{"x": X[i], "y": y[i]} for i in idx],
                                num_workers=24, seed=0, record_every=1)
        return eng.run({"w": torch.zeros(64)},
                       DeviceDataset({"x": X, "y": y}, 24, indices=idx,
                                     device=device),
                       num_workers=24, seed=0, record_every=1,
                       return_state=True)

    fg, hg, sg = run("cuda")
    fc, hc, sc = run("cpu")
    assert hg["averages"] == hc["averages"] == 6
    assert [t for t, _ in hg["dispersion"]] == [t for t, _ in
                                                hc["dispersion"]]
    np.testing.assert_array_equal(sg.fault.alive, sc.fault.alive)
    np.testing.assert_array_equal(sg.fault.staleness, sc.fault.staleness)
    np.testing.assert_allclose([v for _, v in hg["loss"]],
                               [v for _, v in hc["loss"]], rtol=1e-4,
                               atol=1e-7)
    if variant == "int8":
        cc.count_quantum_flips(sg.plane.cpu(), sc.plane, rtol=1e-4,
                               atol=1e-6)
    else:
        np.testing.assert_allclose(fg["w"].cpu().numpy(), fc["w"].numpy(),
                                   rtol=1e-4, atol=1e-6)
    fh, hh = run("cuda", host=True)
    assert torch.equal(fh["w"], fg["w"]) and hh["loss"] == hg["loss"]


# ---- the serving kernels -----------------------------------------------------

FLASH_CASES = [(sh, c, w, dt) for sh in cc.FLASH_SHAPES
               for c, w in cc.FLASH_MASKS for dt in cc.FLASH_DTYPES]


@pytest.mark.parametrize(
    "shape,causal,window,dtype", FLASH_CASES,
    ids=lambda v: ("B{}S{}H{}K{}D{}".format(*v) if isinstance(v, tuple)
                   else str(v).replace("torch.", "")))
def test_flash_attention_kernel_matches_plain(dev, shape, causal, window,
                                              dtype):
    q, k, v = cc.flash_inputs(dev, shape, dtype)
    n0 = flash_attention.launches
    cc.check_flash("flash", q, k, v, causal=causal, window=window)
    assert flash_attention.launches == n0 + 2


@pytest.mark.parametrize("arch", list(cc.FLASH_SERVE))
def test_flash_attention_kernel_at_serving_shape(dev, arch):
    shape, causal, window = cc.FLASH_SERVE[arch]
    q, k, v = cc.flash_inputs(dev, shape, torch.bfloat16)
    n0 = flash_attention.launches
    cc.check_flash(arch, q, k, v, causal=causal, window=window,
                   tol=cc.FLASH_SERVE_TOL)
    assert flash_attention.launches == n0 + 2


@pytest.mark.parametrize("dtype,kernel,other", [
    (torch.bfloat16, "flash_fwd_wgmma", "flash_fwd_f32"),
    (torch.float32, "flash_fwd_f32", "flash_fwd_wgmma")],
    ids=["bfloat16", "float32"])
def test_flash_attention_takes_its_dtype_kernel(dev, dtype, kernel, other):
    """bf16 inputs launch the tensor-core kernel, f32 the CUDA-core one:
    one launch counted, that kernel and not the other in the profiler's
    trace, and ptxas's report of the build holds it at every head dim."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    q, k, v = cc.flash_inputs(dev, (1, 256, 2, 1, 64), dtype)
    flash_attention(q, k, v, causal=True)  # builds and warms up
    torch.cuda.synchronize()
    n0 = flash_attention.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    names = [e.key for e in prof.key_averages()]
    assert any(kernel in n for n in names), names
    assert not any(other in n for n in names), names
    ptxas = [r["kernel"] for r in
             _build.build_all()["ptxas"]["flash_attention"]]
    for hd in HEAD_DIMS:
        assert any(f"{kernel}ILi{hd}E" in n for n in ptxas), (hd, ptxas)


@pytest.mark.parametrize("hd", cc.FLASH_NO_SPILL_HEAD_DIMS)
def test_flash_wgmma_builds_without_spills(dev, hd):
    """ptxas's report of the build: ``flash_fwd_wgmma<hd>`` spills no
    register at the head dims the served archs take (128: starcoder2,
    minitron, gemma3, phi3.5-moe, llama4)."""
    from repro_torch.kernels import _build
    rows = [r for r in _build.build_all()["ptxas"]["flash_attention"]
            if f"flash_fwd_wgmmaILi{hd}E" in r["kernel"]]
    assert len(rows) == 1, rows
    assert rows[0]["spill_stores"] == 0 and rows[0]["spill_loads"] == 0, \
        rows[0]


@pytest.mark.parametrize("shape", cc.RGLRU_SHAPES,
                         ids=lambda s: "B{}S{}W{}".format(*s))
def test_rglru_scan_kernel_matches_plain(dev, shape):
    a, b = cc.rglru_inputs(dev, shape)
    n0 = rglru_scan.launches
    cc.check_rglru("rglru", a, b)
    assert rglru_scan.launches == n0 + 2


@pytest.mark.parametrize(
    "shape,dtype,u_shape,decay", cc.RWKV6_CASES + [cc.RWKV6_SERVE],
    ids=lambda v: ("B{}S{}H{}N{}".format(*v) if isinstance(v, tuple)
                   else str(v).replace("torch.", "")))
def test_rwkv6_scan_kernel_matches_plain(dev, shape, dtype, u_shape, decay):
    n0 = rwkv6_scan.launches
    cc.check_rwkv6("rwkv6", *cc.rwkv6_inputs(dev, shape, dtype, u_shape,
                                             decay))
    assert rwkv6_scan.launches == n0 + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
def test_rwkv6_scan_runs_the_tensor_core_kernel(dev, dtype):
    """One launch of ``rwkv6_chunk_mma`` per call, in the profiler's trace,
    and ptxas's report of the build holds it at every head dim and input
    type."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan import HEAD_DIMS
    wkv = cc.rwkv6_inputs(dev, (1, 64, 2, 64), dtype)
    rwkv6_scan(*wkv)  # builds and warms up
    torch.cuda.synchronize()
    n0 = rwkv6_scan.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rwkv6_scan(*wkv)
        torch.cuda.synchronize()
    assert rwkv6_scan.launches == n0 + 1
    names = [e.key for e in prof.key_averages()]
    assert any("rwkv6_chunk_mma" in n for n in names), names
    ptxas = [r["kernel"] for r in _build.build_all()["ptxas"]["rwkv6_scan"]]
    mangled = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
    for n in HEAD_DIMS:
        assert any(f"rwkv6_chunk_mmaILi{n}E{mangled}E" in x for x in ptxas), \
            (n, ptxas)


def test_rwkv6_scan_refuses_what_it_cannot_take(dev):
    r, k, v, lw, u = cc.rwkv6_inputs(dev, (1, 8, 2, 32), torch.float32)
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan(r, k, v, lw.bfloat16(), u)
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan(r, k, v, lw, u.bfloat16())
    with pytest.raises(ValueError, match="one type"):
        rwkv6_scan(r.bfloat16(), k, v, lw, u)
    with pytest.raises(ValueError, match="one type"):
        rwkv6_scan(r.half(), k.half(), v.half(), lw, u)
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, lw,
                   u)
    with pytest.raises(ValueError, match="on cuda"):
        rwkv6_scan(r, k.cpu(), v, lw, u)
    off = torch.empty(r.numel() + 1, device=dev)[1:].view(r.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rwkv6_scan(r, k, off.copy_(v), lw, u)
    r, k, v, lw, u = cc.rwkv6_inputs(dev, (1, 8, 1, 128), torch.float32)
    with pytest.raises(ValueError, match="n in"):
        rwkv6_scan(r, k, v, lw, u)


def test_serving_kernels_refuse_what_they_cannot_take(dev):
    q, k, v = cc.flash_inputs(dev, (1, 16, 4, 2, 32), torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :16], k[..., :16], v[..., :16])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="on cuda"):
        flash_attention(q, k.cpu(), v)
    a, b = cc.rglru_inputs(dev, (2, 8, 16))
    with pytest.raises(ValueError, match="float32"):
        rglru_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(0, 1), b.transpose(0, 1))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "smollm-360m",
                                  "rwkv6-7b"])
def test_serve_on_card_matches_cpu(dev, arch):
    """Reduced float32 model, CPU-initialized params: the prefill's
    logits and cache and the decode logits on the card (the kernels)
    against the CPU (their plain versions) within rtol / atol 1e-4, the
    launches one per attention / RG-LRU layer of the prefill (an RWKV
    layer's capture takes the chunked path: none) and none in decode,
    the greedy tokens equal; and the cacheless prefill step, one
    ``rwkv6_scan`` per RWKV layer, against the CPU within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.core.flat import tree_flatten
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    gparams = torch.utils._pytree.tree_map(lambda t: t.to(dev), params)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 80)))
    def counts():
        return (flash_attention.launches, rglru_scan.launches,
                rwkv6_scan.launches)

    n0 = counts()
    gl, gc = serve.prefill(cfg, gparams, prompt.to(dev), max_len=6)
    n_rg = sum(s.mixer == "rglru" for s in cfg.layers)
    n_attn = sum(s.mixer in ("attn", "attn_local") for s in cfg.layers)
    assert tuple(a - b for a, b in zip(counts(), n0)) == (n_attn, n_rg, 0)
    cl, cc_ = serve.prefill(cfg, params, prompt, max_len=6)
    np.testing.assert_allclose(gl.cpu().numpy(), cl.numpy(), rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(tree_flatten(gc["layers"])[0],
                    tree_flatten(cc_["layers"])[0]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    n1 = counts()
    gt = serve.decode(cfg, gparams, gl, gc, max_len=6)
    assert counts() == n1
    ct = serve.decode(cfg, params, cl, cc_, max_len=6)
    np.testing.assert_array_equal(gt.cpu().numpy(), ct.numpy())
    from repro_torch.launch import steps
    step = steps.make_prefill_step(cfg)
    gs = step(gparams, {"tokens": prompt.to(dev)})
    n_rwkv = sum(s.mixer == "rwkv" for s in cfg.layers)
    assert tuple(a - b for a, b in zip(counts(), n1)) \
        == (n_attn, n_rg, n_rwkv)
    np.testing.assert_allclose(gs.cpu().numpy(),
                               step(params, {"tokens": prompt}).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_cnn_engine_on_card_matches_cpu(dev):
    """The paper's §3.2 CNN at ``CNNConfig``'s widths, periodic-10 over a
    ``DeviceDataset``: 20 steps, each on the card (``opt_step`` every
    step, ``avg_disp`` at each event) and on the CPU from the CPU's
    state, TF32 off; the same event steps, the loss within rtol 1e-5,
    and at most 1% of the params and velocity planes after each step
    beyond 1e-5 of each plane's largest magnitude
    (``chip_smoke.CNN_LOSS_RTOL`` / ``CNN_PLANE_TOL`` /
    ``CNN_FLIP_FRAC``: float32 sums in other orders, and the gradients
    behind a ReLU or max-pool decision an ulp flips). A common
    state each step: the recipe's first steps are violent enough (the
    loss climbs from 2.8 to 12) that two free-running runs part as
    their last bits are amplified."""
    from repro_torch import rng
    from repro_torch.configs.paper import CNNConfig
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.data import DeviceDataset, mnist_like
    from repro_torch.models import cnn_loss, init_cnn
    from repro_torch.optim import Momentum

    cfg = CNNConfig()
    images, labels = mnist_like(1024, seed=0, noise=0.6)
    arrays = {"images": images, "labels": labels}
    idx = DeviceDataset(arrays, 4, batch_size=8, seed=0, mode="permute",
                        device="cpu").index_block(20)
    eng_g, eng_c = (PhaseEngine(lambda p, b, r: (cnn_loss(cfg, p, b), {}),
                                Momentum(lr=cfg.lr, mu=cfg.momentum),
                                AveragingSchedule("periodic", phase_len=10),
                                device=d) for d in (dev, "cpu"))
    ds_g, ds_c = (DeviceDataset(arrays, 4, indices=idx, device=d)
                  for d in (dev, "cpu"))
    st_c = eng_c.init(init_cnn(cfg, rng.PRNGKey(0), device="cpu"), 4, 0)
    n_opt, n_avg = opt_step.launches, avg_disp.launches
    events = []
    for _ in range(20):
        st_g = st_c._replace(plane=st_c.plane.to(dev), opt_planes=tuple(
            p.to(dev) for p in st_c.opt_planes))
        _, hg, st_g = eng_g.run(None, ds_g, num_workers=4, steps=1,
                                state=st_g, record_every=1,
                                return_state=True)
        _, hc, st_c = eng_c.run(None, ds_c, num_workers=4, steps=1,
                                state=st_c, record_every=1,
                                return_state=True)
        assert [t for t, _ in hg["dispersion"]] == \
            [t for t, _ in hc["dispersion"]]
        events += [t for t, _ in hg["dispersion"]]
        np.testing.assert_allclose(hg["loss"][0][1], hc["loss"][0][1],
                                   rtol=1e-5)
        for a, b in zip((st_g.plane,) + st_g.opt_planes,
                        (st_c.plane,) + st_c.opt_planes):
            d = (a.cpu() - b).abs() / b.abs().max()
            assert float((d > 1e-5).float().mean()) <= 1e-2
    assert events == [10, 20]
    assert (opt_step.launches - n_opt, avg_disp.launches - n_avg) == (20, 2)
