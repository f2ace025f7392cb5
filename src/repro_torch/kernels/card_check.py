"""Each kernel against its plain version, on the card: the shape sweep,
the input builder and the comparison that ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` both run.

Criteria: mode "none" planes and every state plane bitwise equal to the
plain version (the kernels build with -fmad=false, so each product and
sum rounds as PyTorch's separate eager ops do); ``opt_step``'s mean /
group planes within rtol 1e-6 / atol 1e-7 on f32 columns and one dtype
ulp on bf16/f16 columns; ``avg_disp``'s planes bitwise, with and
without rounding codes (f32, all-bf16 and mixed columns,
``CODE_KINDS``); dispersion rtol 1e-5; two runs bitwise identical (no
atomics). A failed check raises ``AssertionError``.

The serving kernels: ``flash_attention`` is held to its plain version
within the JAX suite's tolerance — rtol / atol 2e-5 in float32 (the dot
products are summed in another order, with FMAs, than the plain
version's cuBLAS float32 products) and 3e-2 in bfloat16 (both round the
float32 result to bfloat16 once, so they differ by at most about one
bfloat16 ulp). At the bf16 serving shapes, where most rows see 1-3k
keys and their outputs are several times smaller, it is held within
atol 4e-3 + rtol 2**-7 (``FLASH_SERVE_TOL``): one ulp at any magnitude,
and a tenth of such a row's rms below it. ``rglru_scan`` is held bitwise: a multiply and an add,
each rounded on its own, step by step, as the plain version computes.
``rwkv6_scan`` takes the chunked form on the tensor cores (3xTF32), so
its sums are reassociated and its decays multiplied as exp of a sum: it
is held within the JAX suite's rtol / atol 2e-5 (``RWKV6_TOL``) of the
same recurrence evaluated in float64 (``rwkv6_scan_ref(...,
dtype=torch.float64)``), at the suite's shapes, at rwkv6-7b's serving
shape (bf16 r, k, v, the model's decay range) and at steep and mixed
decay laws that run the kernel's sequential-chunk branch. The yardstick
is float64 and not the sequential float32 plain version because at the
model's magnitudes that version is itself one to several tolerances
away from the exact answer; its own error against the yardstick is
reported beside the kernel's. All three run twice and must agree bitwise with
themselves (no atomics).

The communication kernels — ``mix_disp`` and ``avg_disp_outer`` (with
and without codes), ``opt_step`` mode mix, ``compressed_mix`` and the
``opt_step`` wire path —
are held bitwise to their plain versions: the mix is the same j-ordered
sum of separately rounded products, the int8 quantizer the same IEEE
division, floor and clamp. one_bit's row scale is a float64 sum in
another order on each side, rounded to float32: the two agree unless
the float64 sums straddle a float32 rounding tie, so one_bit is held to
a bound instead — at most one float32 ulp of the row's scale on every
f32 column and on the residual (a scale one ulp apart moves each
decoded value by that ulp, and their mean or mix by no more), one dtype
ulp on top of it on coded columns.

The fault paths (``alive`` / ``umask``, :func:`fault_sweep`) run over
``COMM_SHAPES`` with dead, straggling and all-alive masks
(:func:`fault_masks`), each against its masked plain version. Dead rows
(and, for ``opt_step``, every row outside the update mask in mode
"none", and the state planes' frozen rows) must equal their inputs bit
for bit. Every kernel masks in its one pass: the update, the
degraded-``W`` mix and the masked (group) mean (the alive rows summed
in order and divided once, as the plain versions do; a group with no
alive row left as it is) are bitwise the plain versions, with and
without codes — one_bit within its bound above — and each call is one
launch of its own kernel (``opt_step`` with a wire, one of it and one
of ``compressed_mix``), so a masked mean launches no ``mix_disp``.
Dispersions rtol 1e-5; two runs bitwise.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import faults, rng
from repro_torch.core.compress import row_scales
from repro_torch.kernels import avg_disp as _avg_mod
from repro_torch.kernels import opt_step as _opt_mod
from repro_torch.kernels import ref
from repro_torch.kernels.avg_disp import (avg_disp, avg_disp_outer,
                                          compressed_mix,
                                          compressed_mix_plain, mix_disp)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.opt_step import opt_step
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.topology import Topology, gossip_matrix

# (M, P, groups of mode "group"): ragged P against the 1024-column
# block, every register-array size M rounds up to (4, 8, 32, 64), and
# (24, 1024) is the paper's least-squares plane on the f32 main path.
SHAPES = [(4, 1000, 2), (8, 2500, 4), (24, 1024, 4), (64, 333, 8)]
# (M, P) planes the paper's §3.1 convex suite gives opt_step and avg_disp
# that SHAPES lacks, held bitwise: one worker (the single-worker curve,
# 1 x 1024; modes none and mean only, since a group count must divide M)
# and a plane narrower than one column block (synth-lr-dense, 24 x 32).
NARROW_SHAPES = [(1, 1024), (24, 32)]
# avg_disp group counts, each dividing every M of SHAPES; 4 is the
# hierarchical inner event of the f32 main path.
AVG_GROUPS = (1, 2, 4)
# the rounding codes of avg_disp and mix_disp (make_inputs): f32 columns
# only, every column bf16 (the LM planes), and codes 0/1/2 at random
CODE_KINDS = (None, "bf16", "mixed")
OPTS = {"sgd": ("sgd", {}), "momentum": ("momentum", {"mu": 0.9}),
        "nesterov": ("momentum", {"mu": 0.9, "nesterov": True}),
        "adamw": ("adamw", {"b1": 0.9, "b2": 0.95, "eps": 1e-8,
                            "weight_decay": 0.01})}
NSTATE = {"sgd": 0, "momentum": 1, "adamw": 2}
# the communication kernels' (M, P, groups): every register-array size,
# P ragged against both the 256-column sweep block and the 4096-column
# block of compressed_mix's row-statistic pass (4097: one full block and
# one column), and (24, 1024), the plane the f32 main path gives mix_disp,
# avg_disp_outer, compressed_mix and opt_step's mix and wire paths
COMM_SHAPES = [(4, 10001, 2), (8, 5003, 4), (24, 1024, 4), (24, 4097, 4),
               (64, 333, 8)]
MIXES = ("ring", "hypercube", "gossip", "random")
WIRES = ("bf16", "int8", "one_bit")


def _require(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def make_inputs(dev, m, p, kind, codes_kind=None, seed=0, scale=1.0):
    """(x, g, state planes, scalars, codes) drawn on ``dev`` from
    ``seed``. ``codes_kind``: None (f32 columns only), "mixed" (codes
    0/1/2 at random) or "bf16" (every column bf16, x on the bf16 grid).
    ``scale`` scales the gradient and the state planes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, p, device=dev, generator=g)
    if codes_kind == "bf16":
        x = x.to(torch.bfloat16).float()
    gr = torch.randn(m, p, device=dev, generator=g) * scale
    st = [torch.randn(m, p, device=dev, generator=g) * scale
          for _ in range(NSTATE[kind])]
    if kind == "adamw":
        st[1] = st[1].abs()
    if codes_kind == "mixed":
        codes = torch.randint(0, 3, (p,), device=dev, generator=g).float()
    elif codes_kind == "bf16":
        codes = torch.ones(p, device=dev)
    else:
        codes = None
    scal = torch.tensor([0.05, 0.19, 0.0975, 0.0])
    return x, gr, tuple(st), scal, codes


def dtype_ulp(v, codes):
    """One ulp of ``|v|`` in the dtype each column's code names (1 bf16,
    2 f16)."""
    e = torch.frexp(v.abs())[1] - 1
    bf = torch.ldexp(torch.ones_like(v), e - 7)
    f16 = torch.ldexp(torch.ones_like(v), torch.clamp(e, min=-14) - 10)
    return torch.where(codes == 1.0, bf, f16)


def max_err(name, got, want, codes=None, exact=False, rtol=1e-6,
            atol=1e-7) -> float:
    """Max |got - want|, row by row (full-width rows are 1.4 GB). Raises
    unless bitwise equal (``exact``) or within rtol/atol on f32 columns
    and one dtype ulp on coded columns."""
    worst = 0.0
    for i in range(got.shape[0]):
        a, b = got[i], want[i]
        if torch.equal(a, b):
            continue
        _require(not exact, f"{name}: row {i} not bitwise equal")
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        lim = atol + rtol * b.abs()
        if codes is not None:
            lim = torch.where(codes == 0.0, lim, dtype_ulp(
                torch.maximum(a.abs(), b.abs()), codes))
        _require(bool((d <= lim).all()), f"{name}: row {i} out of "
                 f"tolerance (max abs err {float(d.max())})")
    return worst


def check_opt_step(name, x, g, st, scal, codes, **kw):
    """Run ``opt_step`` twice on fresh copies of x and the state planes
    (it updates them in place) and hold it against ``opt_step_ref``.
    Returns (max abs error of the plane, the kernel's dispersion)."""
    def run():
        xk, sk = x.clone(), tuple(s.clone() for s in st)
        out = opt_step(xk, g, sk, scal, codes=codes, **kw)
        # the kernel updates in place; the plain version (CPU) does not
        _require(out[0] is xk or not xk.is_cuda,
                 f"{name}: x not updated in place")
        return out

    want_x, want_s, want_d = ref.opt_step_ref(x, g, st, scal, codes=codes,
                                              **kw)
    got_x, got_s, got_d = run()
    err = max_err(name, got_x, want_x, codes,
                  exact=kw["mode"] in ("none", "mix"))
    for a, b in zip(got_s, want_s):
        max_err(f"{name}/state", a, b, exact=True)
    # freed before the second run: at full width each plane is 5.8 GB
    del want_x, want_s
    d_k, d_p = float(got_d), float(want_d)
    _require(math.isclose(d_k, d_p, rel_tol=1e-5),
             f"{name}: dispersion {d_k} vs plain {d_p}")
    x2, s2, d2 = run()
    _require(torch.equal(x2, got_x) and float(d2) == d_k
             and all(torch.equal(a, b) for a, b in zip(s2, got_s)),
             f"{name}: two runs differ")
    return err, d_k


def mixing_matrix(name, m, dev):
    """An (M, M) f32 doubly-stochastic W on ``dev``: a ring, a hypercube
    (a torus where M is no power of two), a gossip matching, or a random
    convex mix of permutation matrices."""
    if name == "ring":
        return Topology.ring(m).mixing_matrix(device=dev)
    if name == "hypercube":
        t = (Topology.hypercube(m) if m & (m - 1) == 0
             else Topology.torus(m))
        return t.mixing_matrix(device=dev)
    if name == "gossip":
        return gossip_matrix(rng.PRNGKey(m), 1, m, dev)
    g = torch.Generator().manual_seed(m)
    w = torch.rand(4, generator=g, dtype=torch.float64)
    W = sum(wk / w.sum() * torch.eye(m, dtype=torch.float64)[
        torch.randperm(m, generator=g)] for wk in w)
    return W.float().to(dev)


def wire_inputs(dev, m, p, seed, uniforms=True):
    """(residual, uniforms or None) drawn on ``dev`` from ``seed``; the
    uniforms come from a seeded ``torch.Generator`` — only an input
    here."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = torch.randn(m, p, device=dev, generator=g) * 1e-2
    return r, (torch.rand(m, p, device=dev, generator=g) if uniforms
               else None)


def _wire_bound(v, wire):
    """The allowed |kernel - plain| of a compressed event (module note):
    0 but for one_bit, one f32 ulp of the largest row scale."""
    if wire != "one_bit":
        return 0.0
    s = float(row_scales(v, "one_bit").max())
    return math.ulp(s)


def max_err_bound(name, got, want, bound, codes=None) -> float:
    """Max |got - want| row by row; raises unless every entry is within
    ``bound`` (plus one dtype ulp on coded columns), or equal when the
    bound is 0."""
    if bound == 0.0:
        return max_err(name, got, want, exact=True)
    worst = 0.0
    for i in range(got.shape[0]):
        d = (got[i] - want[i]).abs()
        worst = max(worst, float(d.max()))
        lim = torch.full_like(d, bound)
        if codes is not None:
            lim = torch.where(codes == 0.0, lim, lim + dtype_ulp(
                torch.maximum(got[i].abs(), want[i].abs()), codes))
        _require(bool((d <= lim).all()), f"{name}: row {i} beyond the "
                 f"one_bit bound (max abs err {float(d.max())})")
    return worst


def count_quantum_flips(got, want, *, rtol, atol, max_frac=0.01) -> int:
    """Entries of two int8-trained planes outside rtol/atol of each other,
    counted. Where two devices' gradients differ in the last bit, int8's
    floor(v / s + u) can land one quantum s = max|v| / 127 apart, and the
    runs carry that entry on from there. Raises if more than
    ``max_frac`` of the entries differ so, or any by more than two quanta
    of the plane's largest row scale; returns the count."""
    d = (got - want).abs()
    out = d > atol + rtol * want.abs()
    n = int(out.sum())
    quantum = float(want.abs().max()) / 127.0
    _require(n <= max_frac * want.numel(),
             f"{n} of {want.numel()} entries beyond rtol {rtol}")
    worst = float(d[out].max()) if n else 0.0
    _require(worst <= 2 * quantum, f"an entry differs by {worst}, over "
             f"two int8 quanta ({quantum})")
    return n


def check_mix_disp(name, x, W, codes=None) -> float:
    """Run ``mix_disp`` twice and hold it against ``mix_disp_ref``
    bitwise. Returns the max abs error of the plane, 0."""
    want, want_d = ref.mix_disp_ref(x, W, codes=codes)
    got, got_d = mix_disp(x, W, codes=codes)
    err = max_err(name, got, want, exact=True)
    del want
    _require(math.isclose(float(got_d), float(want_d), rel_tol=1e-5),
             f"{name}: dispersion {float(got_d)} vs plain {float(want_d)}")
    got2, d2 = mix_disp(x, W, codes=codes)
    _require(torch.equal(got2, got) and float(d2) == float(got_d),
             f"{name}: two runs differ")
    return err


def outer_inputs(dev, m, p, codes_kind=None, seed=0):
    """(x, prev, vel, codes) of an ``avg_disp_outer`` call drawn on
    ``dev`` from ``seed``: x and codes as :func:`make_inputs` draws them,
    prev on the codes' grid (as the engine's outer state is), vel f32."""
    x, _, _, _, codes = make_inputs(dev, m, p, "sgd", codes_kind, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    prev = torch.randn(p, device=dev, generator=g)
    vel = torch.randn(p, device=dev, generator=g) * 1e-2
    if codes is not None:
        prev = ref.round_to_codes(prev, codes)
    return x, prev, vel, codes


def check_avg_disp_outer(name, x, prev, vel, codes=None, **kw) -> float:
    """Run ``avg_disp_outer`` twice and hold the plane and the outer
    state bitwise against ``avg_disp_outer_ref`` (with and without
    rounding codes). Returns the max abs error."""
    kw["codes"] = codes
    want = ref.avg_disp_outer_ref(x, prev, vel, **kw)
    got = avg_disp_outer(x, prev, vel, **kw)
    err = max_err(name, got[0], want[0], exact=True)
    for a, b, what in ((got[1], want[1], "avg"), (got[2], want[2], "vel")):
        _require(torch.equal(a, b), f"{name}: new {what} not bitwise equal")
    _require(math.isclose(float(got[3]), float(want[3]), rel_tol=1e-5),
             f"{name}: dispersion {float(got[3])} vs plain "
             f"{float(want[3])}")
    del want
    again = avg_disp_outer(x, prev, vel, **kw)
    _require(all(torch.equal(a, b) for a, b in zip(again, got)),
             f"{name}: two runs differ")
    return err


def check_compressed(name, x, r, *, wire, mode, groups=1, W=None, u=None,
                     codes=None, error_feedback=True) -> float:
    """Run ``compressed_mix`` twice on fresh copies of the plane and the
    residual (it updates both in place) and hold both against the plain
    event, bitwise (one_bit: the bound of the module note). Returns the
    max abs error."""
    kw = dict(wire=wire, u=u, codes=codes, error_feedback=error_feedback)
    if mode == "mix":
        want_x, want_r, want_d = ref.compressed_mix_ref(x, r, W, **kw)
    else:
        want_x, want_r, want_d = ref.compressed_avg_ref(
            x, r, groups=groups if mode == "group" else 1, **kw)
    bound = _wire_bound(x + r if error_feedback else x, wire)

    def run():
        xk, rk = x.clone(), r.clone()
        out = compressed_mix(xk, rk, mode=mode, groups=groups, W=W, **kw)
        # the kernel updates in place; the plain version (CPU) does not
        _require((out[0] is xk and out[1] is rk) or not xk.is_cuda,
                 f"{name}: plane / residual not updated in place")
        return out

    got_x, got_r, got_d = run()
    err = max(max_err_bound(name, got_x, want_x, bound, codes),
              max_err_bound(f"{name}/resid", got_r, want_r, bound))
    del want_x, want_r
    _require(math.isclose(float(got_d), float(want_d), rel_tol=1e-5),
             f"{name}: dispersion {float(got_d)} vs plain {float(want_d)}")
    x2, r2, d2 = run()
    _require(torch.equal(x2, got_x) and torch.equal(r2, got_r)
             and float(d2) == float(got_d), f"{name}: two runs differ")
    return err


def check_opt_step_wire(name, x, g, st, scal, codes, r, u, **kw) -> float:
    """The ``opt_step`` wire path run twice on fresh copies of x, the
    state planes and the residual, against ``opt_step_ref``: state
    planes bitwise, plane and residual bitwise (one_bit: the bound of the
    module note, taken on the plain version's updated plane). Returns
    the max abs error."""
    def run():
        xk, rk = x.clone(), r.clone()
        sk = tuple(s.clone() for s in st)
        out = opt_step(xk, g, sk, scal, codes=codes, resid=rk, u=u, **kw)
        _require((out[0] is xk and out[2] is rk) or not xk.is_cuda,
                 f"{name}: plane / residual not updated in place")
        return out

    want_x, want_s, want_r, want_d = ref.opt_step_ref(
        x, g, st, scal, codes=codes, resid=r, u=u, **kw)
    bound = 0.0
    if kw["wire"] == "one_bit":
        upd = ref.plane_update_ref(x, g, st, scal, codes=codes,
                                   **{k: v for k, v in kw.items()
                                      if k in ("kind", "mu", "nesterov",
                                               "b1", "b2", "eps",
                                               "weight_decay")})[0]
        v = upd + r if kw.get("error_feedback", True) else upd
        bound = _wire_bound(v, "one_bit")
        del upd, v
    got_x, got_s, got_r, got_d = run()
    err = max(max_err_bound(name, got_x, want_x, bound, codes),
              max_err_bound(f"{name}/resid", got_r, want_r, bound))
    for a, b in zip(got_s, want_s):
        max_err(f"{name}/state", a, b, exact=True)
    del want_x, want_s, want_r
    _require(math.isclose(float(got_d), float(want_d), rel_tol=1e-5),
             f"{name}: dispersion {float(got_d)} vs plain {float(want_d)}")
    x2, s2, r2, d2 = run()
    _require(torch.equal(x2, got_x) and torch.equal(r2, got_r)
             and float(d2) == float(got_d)
             and all(torch.equal(a, b) for a, b in zip(s2, got_s)),
             f"{name}: two runs differ")
    return err


def check_avg_disp(name, x, groups, codes=None) -> float:
    """Run ``avg_disp`` twice and hold it bitwise against
    ``plane_average_ref``. Returns the max abs error of the plane, 0."""
    want, want_d = ref.plane_average_ref(x, groups=groups, codes=codes)
    got, got_d = avg_disp(x, groups=groups, codes=codes)
    err = max_err(name, got, want, exact=True)
    del want
    _require(math.isclose(float(got_d), float(want_d), rel_tol=1e-5),
             f"{name}: dispersion {float(got_d)} vs plain {float(want_d)}")
    got2, d2 = avg_disp(x, groups=groups, codes=codes)
    _require(torch.equal(got2, got) and float(d2) == float(got_d),
             f"{name}: two runs differ")
    return err


def comm_sweep(dev) -> tuple[int, dict]:
    """The communication kernels over ``COMM_SHAPES``: ``mix_disp`` (every
    codes kind) and ``opt_step`` mode mix under every W of ``MIXES``,
    ``avg_disp_outer`` with Nesterov on and off over every codes kind,
    and ``compressed_mix`` and the ``opt_step``
    wire path over every wire x mean / group / mix x codes x error
    feedback. Returns (number of cases, max abs error per kernel)."""
    err = {"opt_step": 0.0, "mix_disp": 0.0, "avg_disp_outer": 0.0,
           "compressed_mix": 0.0}
    n = 0
    opts = list(OPTS)
    for m, p, groups in COMM_SHAPES:
        for k, wname in enumerate(MIXES):
            W = mixing_matrix(wname, m, dev)
            for codes_kind in CODE_KINDS:
                x, _, _, _, codes = make_inputs(dev, m, p, "sgd", codes_kind,
                                                seed=2000 + n)
                e = check_mix_disp(f"mix_disp/{wname}-{codes_kind}-M{m}P{p}",
                                   x, W, codes)
                err["mix_disp"] = max(err["mix_disp"], e)
                n += 1
            kind, hyp = OPTS[opts[k]]
            for codes_kind in (None, "mixed"):
                x, g, st, scal, codes = make_inputs(dev, m, p, kind,
                                                    codes_kind, seed=n)
                e, _ = check_opt_step(
                    f"opt_step/mix-{wname}-{opts[k]}-{codes_kind}-M{m}P{p}",
                    x, g, st, scal, codes, kind=kind, mode="mix", W=W,
                    **hyp)
                err["opt_step"] = max(err["opt_step"], e)
                n += 1
        for nesterov in (True, False):
            for codes_kind in CODE_KINDS:
                e = check_avg_disp_outer(
                    f"avg_disp_outer/nesterov={nesterov}-{codes_kind}-"
                    f"M{m}P{p}", *outer_inputs(dev, m, p, codes_kind,
                                               seed=3000 + n),
                    lr=0.7, momentum=0.5, nesterov=nesterov)
                err["avg_disp_outer"] = max(err["avg_disp_outer"], e)
                n += 1
        W = mixing_matrix("ring", m, dev)
        for wire in WIRES:
            for mode in ("mean", "group", "mix"):
                for codes_kind in (None, "mixed"):
                    for ef in (True, False):
                        x, g, st, scal, codes = make_inputs(
                            dev, m, p, "momentum", codes_kind, seed=n)
                        r, u = wire_inputs(dev, m, p, seed=n)
                        kw = dict(wire=wire, mode=mode,
                                  groups=groups if mode == "group" else 1,
                                  W=W if mode == "mix" else None,
                                  error_feedback=ef)
                        uu = u if wire == "int8" else None
                        tag = f"{wire}-{mode}-{codes_kind}-ef{int(ef)}-M{m}"
                        e = check_compressed(f"compressed_mix/{tag}", x, r,
                                             u=uu, codes=codes, **kw)
                        err["compressed_mix"] = max(err["compressed_mix"],
                                                    e)
                        e = check_opt_step_wire(
                            f"opt_step/wire-{tag}", x, g, st, scal, codes,
                            r, uu, kind="momentum", mu=0.9, **kw)
                        err["opt_step"] = max(err["opt_step"], e)
                        n += 2
    return n, err


def check_narrow_opt_step(dev, m, p, opt, mode, codes_kind, seed=0) -> float:
    """``opt_step`` on one of ``NARROW_SHAPES``, held bitwise to its plain
    version (mode mean included). Returns the max abs error, 0."""
    kind, hyp = OPTS[opt]
    x, g, st, scal, codes = make_inputs(dev, m, p, kind, codes_kind,
                                        seed=seed)
    name = f"opt_step/{opt}-{mode}-{codes_kind}-M{m}P{p}"
    e, _ = check_opt_step(name, x, g, st, scal, codes, kind=kind, mode=mode,
                          **hyp)
    _require(e == 0.0, f"{name}: not bitwise ({e})")
    return e


def sweep(dev) -> tuple[int, dict]:
    """Every (shape, optimizer, mode, codes) case of ``opt_step`` and
    every (shape, groups, codes) case of ``avg_disp`` over ``SHAPES`` and
    ``NARROW_SHAPES``, then :func:`comm_sweep`.
    Returns (number of cases, max abs error per kernel)."""
    err = {"opt_step": 0.0, "avg_disp": 0.0}
    n = 0
    for m, p, groups in SHAPES:
        for opt, (kind, hyp) in OPTS.items():
            for mode in ("none", "mean", "group"):
                for codes_kind in (None, "mixed"):
                    x, g, st, scal, codes = make_inputs(dev, m, p, kind,
                                                        codes_kind, seed=n)
                    kw = dict(kind=kind, mode=mode,
                              groups=groups if mode == "group" else 1, **hyp)
                    e, _ = check_opt_step(
                        f"opt_step/{opt}-{mode}-{codes_kind}-M{m}P{p}",
                        x, g, st, scal, codes, **kw)
                    err["opt_step"] = max(err["opt_step"], e)
                    n += 1
        for grp in AVG_GROUPS:
            for codes_kind in CODE_KINDS:
                x, _, _, _, codes = make_inputs(dev, m, p, "sgd", codes_kind,
                                                seed=1000 + grp)
                e = check_avg_disp(
                    f"avg_disp/g{grp}-{codes_kind}-M{m}P{p}", x, grp, codes)
                err["avg_disp"] = max(err["avg_disp"], e)
                n += 1
    for m, p in NARROW_SHAPES:
        for opt in OPTS:
            for mode in ("none", "mean"):
                for codes_kind in (None, "mixed"):
                    e = check_narrow_opt_step(dev, m, p, opt, mode,
                                              codes_kind, seed=n)
                    err["opt_step"] = max(err["opt_step"], e)
                    n += 1
        for grp in AVG_GROUPS:
            if m % grp == 0:
                x = make_inputs(dev, m, p, "sgd", seed=1000 + grp)[0]
                check_avg_disp(f"avg_disp/g{grp}-M{m}P{p}", x, grp)
                n += 1
    n2, err2 = comm_sweep(dev)
    for k, v in err2.items():
        err[k] = max(err.get(k, 0.0), v)
    return n + n2, err


# ---- the fault paths --------------------------------------------------------

def fault_masks(m) -> dict:
    """The sweep's ``(alive, umask)`` pairs over M rows: "dead" (row 1,
    and row M-2 from M=8, crashed), "straggle" (the same, and row 0
    alive but skipping its update) and "all-alive"."""
    alive = np.ones(m, np.float32)
    alive[1] = 0.0
    if m >= 8:
        alive[m - 2] = 0.0
    strag = alive.copy()
    strag[0] = 0.0
    ones = np.ones(m, np.float32)
    return {"dead": (alive, alive), "straggle": (alive, strag),
            "all-alive": (ones, ones)}


def empty_group_mask(m, groups) -> np.ndarray:
    """An (M,) alive mask whose first group of M / groups rows is dead
    (its masked group mean has no row, and the group is left as it is),
    with row 1 of the next group dead too."""
    alive = np.ones(m, np.float32)
    gs = m // groups
    alive[:gs] = 0.0
    alive[gs + 1] = 0.0
    return alive


def hold_rows(name, got, want, kept, keep_mask, *, extra=0.0,
              codes=None) -> float:
    """Rows with ``keep_mask <= 0`` bitwise ``kept``'s; the others
    bitwise ``want``'s, or within ``extra`` (+ one dtype ulp on coded
    columns) where it is not 0. Row by row. Returns max |got - want|."""
    m = got.shape[0]
    km = faults.host_mask(keep_mask)
    worst = 0.0
    for i in range(m):
        if km[i] <= 0:
            _require(torch.equal(got[i], kept[i]),
                     f"{name}: kept row {i} changed")
            continue
        if torch.equal(got[i], want[i]):
            continue
        _require(extra > 0.0, f"{name}: row {i} not bitwise equal")
        d = (got[i] - want[i]).abs()
        worst = max(worst, float(d.max()))
        lim = torch.full_like(d, extra)
        if codes is not None:
            lim = torch.where(codes == 0.0, lim, lim + dtype_ulp(
                torch.maximum(got[i].abs(), want[i].abs()), codes))
        _require(bool((d <= lim).all()), f"{name}: row {i} out of its "
                 f"bound (max abs err {float(d.max())})")
    return worst


def _same_disp(name, got_d, want_d) -> float:
    d_k, d_p = float(got_d), float(want_d)
    _require(math.isclose(d_k, d_p, rel_tol=1e-5),
             f"{name}: dispersion {d_k} vs plain {d_p}")
    return d_k


def _launch_counts() -> tuple:
    """(opt_step, compressed_mix, mix_disp, avg_disp) launches so far."""
    return (_opt_mod.opt_step.launches, _avg_mod.compressed_mix.launches,
            _avg_mod.mix_disp.launches, _avg_mod.avg_disp.launches)


def _held_launches(name, before, in_place, want) -> None:
    """On the card's path (the call updated in place), the launches of
    (opt_step, compressed_mix, mix_disp, avg_disp) since ``before``
    equal ``want``."""
    if not in_place:
        return
    got = tuple(a - b for a, b in zip(_launch_counts(), before))
    _require(got == want, f"{name}: launches (opt_step, compressed_mix, "
             f"mix_disp, avg_disp) {got}, want {want}")


def _check_event_fault(name, x, alive, event, plain, launches) -> float:
    """A masked ``avg_disp`` / ``mix_disp`` call, ``event(plane)``, twice
    on fresh copies of ``x`` (in place on the card, one launch of its
    kernel each: ``launches``), against ``plain(x)``: dead rows keep
    their values, alive rows bitwise, the dispersion within rtol 1e-5.
    Returns the max abs error, 0."""
    want, want_d = plain(x)

    def run():
        xk = x.clone()
        before = _launch_counts()
        out = event(xk)
        in_place = out[0] is xk
        _require(in_place or not xk.is_cuda,
                 f"{name}: plane not updated in place")
        _held_launches(name, before, in_place, launches)
        return out

    got, got_d = run()
    err = hold_rows(name, got, want, x, alive)
    del want
    d = _same_disp(name, got_d, want_d)
    got2, d2 = run()
    _require(torch.equal(got2, got) and float(d2) == d,
             f"{name}: two runs differ")
    return err


def check_avg_disp_fault(name, x, alive, groups, codes=None) -> float:
    """``avg_disp(alive=)`` (``avg_disp.cu``'s masked pass) against
    ``plane_average_ref(alive=)`` (:func:`_check_event_fault`)."""
    kw = dict(groups=groups, codes=codes, alive=alive)
    return _check_event_fault(
        name, x, alive, lambda v: avg_disp(v, **kw),
        lambda v: ref.plane_average_ref(v, **kw), (0, 0, 0, 1))


def check_mix_disp_fault(name, x, W, alive, codes=None) -> float:
    """``mix_disp(alive=)`` (``mix_disp.cu``'s masked pass on the degraded
    W) against ``mix_disp_ref(alive=)`` (:func:`_check_event_fault`)."""
    kw = dict(codes=codes, alive=alive)
    return _check_event_fault(
        name, x, alive, lambda v: mix_disp(v, W, **kw),
        lambda v: ref.mix_disp_ref(v, W, **kw), (0, 0, 1, 0))


def check_compressed_fault(name, x, r, alive, *, wire, mode, groups=1,
                           W=None, u=None, codes=None,
                           error_feedback=True) -> float:
    """``compressed_mix(alive=)`` twice on fresh copies (in place on the
    card, one launch each), plane and residual against
    ``compressed_mix_plain(alive=)``: dead rows keep both, alive rows
    bitwise (one_bit within its bound). Returns the max abs error."""
    kw = dict(wire=wire, mode=mode, groups=groups, W=W, u=u, codes=codes,
              error_feedback=error_feedback, alive=alive)
    want_x, want_r, want_d = compressed_mix_plain(x, r, **kw)
    extra = _wire_bound(x + r if error_feedback else x, wire)

    def run():
        xk, rk = x.clone(), r.clone()
        before = _launch_counts()
        out = compressed_mix(xk, rk, **kw)
        in_place = out[0] is xk and out[1] is rk
        _require(in_place or not xk.is_cuda,
                 f"{name}: plane / residual not updated in place")
        _held_launches(name, before, in_place, (0, 1, 0, 0))
        return out

    got_x, got_r, got_d = run()
    err = max(hold_rows(name, got_x, want_x, x, alive, extra=extra,
                        codes=codes),
              hold_rows(f"{name}/resid", got_r, want_r, r, alive,
                        extra=extra))
    del want_x, want_r
    d = _same_disp(name, got_d, want_d)
    x2, r2, d2 = run()
    _require(torch.equal(x2, got_x) and torch.equal(r2, got_r)
             and float(d2) == d, f"{name}: two runs differ")
    return err


def check_opt_step_fault(name, x, g, st, scal, codes, alive, umask, *,
                         resid=None, u=None, **kw) -> float:
    """``opt_step(alive=, umask=)`` twice on fresh copies (on the card one
    launch of ``opt_step.cu`` each, with a ``wire`` one of
    ``compressed_mix.cu`` too, none of ``mix_disp.cu``), against
    ``opt_step_ref(alive=, umask=)``: the state planes bitwise (their
    rows outside ``umask`` the inputs'), the plane's rows in neither
    mask (in mode "none": outside ``umask``) the inputs', its other rows
    bitwise (a one_bit wire: within its bound); with a ``wire`` the
    residual too. Returns the max abs error."""
    wire, mode = kw.get("wire"), kw["mode"]
    want = ref.opt_step_ref(x, g, st, scal, codes=codes, alive=alive,
                            umask=umask, resid=resid, u=u, **kw)
    extra = 0.0
    if wire is not None:
        hyp = {k: v for k, v in kw.items()
               if k in ("kind", "mu", "nesterov", "b1", "b2", "eps",
                        "weight_decay")}
        upd = ref.opt_step_ref(x, g, st, scal, codes=codes, alive=alive,
                               umask=umask, **hyp)[0]
        extra = _wire_bound(upd + resid if kw.get("error_feedback", True)
                            else upd, wire)
        del upd
    kept = (faults.host_mask(umask) if mode == "none" else
            np.maximum(faults.host_mask(alive), faults.host_mask(umask)))

    def run():
        xk, sk = x.clone(), tuple(s.clone() for s in st)
        rk = None if resid is None else resid.clone()
        before = _launch_counts()
        out = opt_step(xk, g, sk, scal, codes=codes, alive=alive,
                       umask=umask, resid=rk, u=u, **kw)
        in_place = out[0] is xk and all(a is b for a, b in zip(out[1], sk))
        _require(in_place or not xk.is_cuda,
                 f"{name}: plane / state planes not updated in place")
        _held_launches(name, before, in_place,
                       (1, int(wire is not None), 0, 0))
        return out

    got = run()
    err = hold_rows(name, got[0], want[0], x, kept, extra=extra,
                    codes=codes)
    for a, b, s0 in zip(got[1], want[1], st):
        hold_rows(f"{name}/state", a, b, s0, umask)
    if wire is not None:
        err = max(err, hold_rows(f"{name}/resid", got[2], want[2], resid,
                                 alive, extra=extra))
    d = _same_disp(name, got[-1], want[-1])
    del want
    again = run()
    _require(all(torch.equal(a, b) for a, b in zip(again[0::2], got[0::2]))
             and all(torch.equal(a, b) for a, b in zip(again[1], got[1]))
             and float(again[-1]) == d, f"{name}: two runs differ")
    return err


def fault_sweep(dev) -> tuple[int, dict]:
    """The four fault paths over ``COMM_SHAPES`` x ``fault_masks``:
    ``avg_disp`` (groups 1 and the shape's) and ``mix_disp`` (ring), each
    over ``CODE_KINDS``, ``compressed_mix`` (every wire x mean / group /
    mix, codes on the bf16 wire) and ``opt_step`` (Momentum and AdamW,
    modes none / mean / group / mix, f32 and coded columns; the wire
    path's three wires); and per shape ``avg_disp``'s group mean with a
    group of dead rows (:func:`empty_group_mask`). Returns (number of
    cases, max abs error per kernel)."""
    err = dict.fromkeys(("opt_step", "avg_disp", "mix_disp",
                         "compressed_mix"), 0.0)
    n = 0
    for m, p, groups in COMM_SHAPES:
        W = mixing_matrix("ring", m, dev)
        for mname, (alive, umask) in fault_masks(m).items():
            tag = f"{mname}-M{m}P{p}"
            for codes_kind in CODE_KINDS:
                x, _, _, _, codes = make_inputs(dev, m, p, "sgd", codes_kind,
                                                seed=4000 + n)
                for grp in (1, groups):
                    e = check_avg_disp_fault(
                        f"avg_disp/fault-g{grp}-{codes_kind}-{tag}", x,
                        alive, grp, codes)
                    err["avg_disp"] = max(err["avg_disp"], e)
                    n += 1
                e = check_mix_disp_fault(
                    f"mix_disp/fault-ring-{codes_kind}-{tag}", x, W, alive,
                    codes)
                err["mix_disp"] = max(err["mix_disp"], e)
                n += 1
            for wire in WIRES:
                for mode in ("mean", "group", "mix"):
                    x, _, _, _, codes = make_inputs(
                        dev, m, p, "sgd", "mixed" if wire == "bf16" else
                        None, seed=n)
                    r, u = wire_inputs(dev, m, p, seed=n)
                    e = check_compressed_fault(
                        f"compressed_mix/fault-{wire}-{mode}-{tag}", x, r,
                        alive, wire=wire, mode=mode,
                        groups=groups if mode == "group" else 1,
                        W=W if mode == "mix" else None,
                        u=u if wire == "int8" else None, codes=codes)
                    err["compressed_mix"] = max(err["compressed_mix"], e)
                    n += 1
            for opt in ("momentum", "adamw"):
                kind, hyp = OPTS[opt]
                for mode in ("none", "mean", "group", "mix"):
                    for codes_kind in (None, "mixed"):
                        x, g, st, scal, codes = make_inputs(
                            dev, m, p, kind, codes_kind, seed=n)
                        e = check_opt_step_fault(
                            f"opt_step/fault-{opt}-{mode}-{codes_kind}-{tag}",
                            x, g, st, scal, codes, alive, umask, kind=kind,
                            mode=mode,
                            groups=groups if mode == "group" else 1,
                            W=W if mode == "mix" else None, **hyp)
                        err["opt_step"] = max(err["opt_step"], e)
                        n += 1
            for wire in WIRES:
                mode = "mix" if wire == "one_bit" else "mean"
                x, g, st, scal, codes = make_inputs(dev, m, p, "momentum",
                                                    seed=n)
                r, u = wire_inputs(dev, m, p, seed=n)
                e = check_opt_step_fault(
                    f"opt_step/fault-wire-{wire}-{mode}-{tag}", x, g, st,
                    scal, codes, alive, umask, resid=r,
                    u=u if wire == "int8" else None, kind="momentum",
                    mu=0.9, mode=mode, wire=wire,
                    W=W if mode == "mix" else None)
                err["opt_step"] = max(err["opt_step"], e)
                n += 1
        x, _, _, _, codes = make_inputs(dev, m, p, "sgd", "mixed",
                                        seed=4000 + n)
        e = check_avg_disp_fault(f"avg_disp/fault-empty-group-M{m}P{p}", x,
                                 empty_group_mask(m, groups), groups, codes)
        err["avg_disp"] = max(err["avg_disp"], e)
        n += 1
    return n, err


# ---- the serving kernels ---------------------------------------------------

#: flash_attention's (batch, sequence, heads, kv heads, head_dim): the JAX
#: suite's four shapes (tests/test_kernels.py: GQA, MHA, MQA, a sequence
#: below one tile), one of head_dim 256 at a small size, a sequence
#: shorter than one TMA box of the bf16 kernel (64 rows), and head_dim
#: 128 at the zoo's GQA ratios 12 (starcoder2-3b: 24 / 2) and 5
#: (llama4-maverick: 40 / 8), over ragged sequences
FLASH_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 4, 4, 32), (1, 384, 8, 1, 128),
                (2, 96, 6, 3, 64), (2, 160, 4, 1, 256), (2, 40, 4, 2, 128),
                (1, 200, 24, 2, 128), (2, 136, 10, 2, 128)]
#: (causal, window): the suite's sweep, and a window without the causal
#: mask
FLASH_MASKS = [(True, 0), (True, 64), (False, 0), (False, 64)]
FLASH_DTYPES = (torch.float32, torch.bfloat16)
#: the serving path's shapes, bf16: recurrentgemma-2b's local attention
#: (MQA, head_dim 256, window 2048, a prompt of 3072) and smollm-360m's
#: (GQA 15 / 5, head_dim 64, a prompt of 2048); then the zoo's, all at
#: head_dim 128 — starcoder2-3b's (GQA 24 / 2, window 4096, a prompt of
#: 5120), minitron-8b's (32 / 8, 2048), gemma3-27b's local and global
#: layers (32 / 16, window 1024, batch 2 x 2048), phi3.5-moe's (32 / 8,
#: 2048) and llama4-maverick's local layers (40 / 8, window 8192 past a
#: prompt of 2048, batch 1); then the encoders and cross-attention
#: archs' self-attention — whisper-small's encoder, unmasked over its
#: 1500 frames (not a multiple of the bf16 kernel's 64-row box: a tail of
#: 28) and its decoder's causal prompt of 384 (12 / 12 heads, head_dim
#: 64, batch 16), llama-3.2-vision-90b's self-attention layers (64 / 8,
#: head_dim 128, batch 2 x 2048); each as (shape, causal, window)
FLASH_SERVE = {"recurrentgemma-2b": ((4, 3072, 10, 1, 256), True, 2048),
               "smollm-360m": ((4, 2048, 15, 5, 64), True, 0),
               "starcoder2-3b": ((4, 5120, 24, 2, 128), True, 4096),
               "minitron-8b": ((4, 2048, 32, 8, 128), True, 0),
               "gemma3-27b-local": ((2, 2048, 32, 16, 128), True, 1024),
               "gemma3-27b-global": ((2, 2048, 32, 16, 128), True, 0),
               "phi3.5-moe-42b-a6.6b": ((4, 2048, 32, 8, 128), True, 0),
               "llama4-maverick-400b-a17b": ((1, 2048, 40, 8, 128), True,
                                             8192),
               "whisper-small-encoder": ((16, 1500, 12, 12, 64), False, 0),
               "whisper-small-decoder": ((16, 384, 12, 12, 64), True, 0),
               "llama-3.2-vision-90b": ((2, 2048, 64, 8, 128), True, 0)}
#: head dims whose bf16 tensor-core kernel (``flash_fwd_wgmma<hd>``) must
#: build without register spills: those the served archs take (32 serves
#: none)
FLASH_NO_SPILL_HEAD_DIMS = (64, 128, 256)
#: (atol, rtol) of the suite's shapes, as the JAX suite holds them
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (3e-2, 3e-2)}
#: (atol, rtol) of the bf16 serving shapes. Most rows there see 1-3k keys
#: of unit-normal values, so their outputs have an rms of only 0.036-0.05
#: and the suite's 3e-2 would pass an error of a typical output's size.
#: rtol 2**-7 admits one bf16 rounding step of the output at any
#: magnitude (the kernel and its twin both accumulate in f32 and round
#: once); atol 4e-3 is about a tenth of such a row's rms
FLASH_SERVE_TOL = (4e-3, 2.0 ** -7)
#: rglru_scan's (batch, sequence, width): the suite's three and
#: recurrentgemma-2b's prefill of 3072 tokens at rnn width 2560
RGLRU_SHAPES = [(2, 64, 512), (1, 300, 1024), (3, 17, 512), (4, 3072, 2560)]


def flash_inputs(dev, shape, dtype, seed=0):
    """(q, k, v) of ``shape`` = (B, S, H, Hkv, hd), standard normal, in
    ``dtype`` on ``dev``."""
    b, s, h, hkv, hd = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(sh, device=dev, generator=g).to(dtype)
                 for sh in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))


def check_flash(name, q, k, v, *, causal, window,
                tol=None) -> tuple[float, float, float]:
    """Run ``flash_attention`` twice and hold it against
    ``flash_attention_ref`` within ``tol`` = (atol, rtol), by default
    ``FLASH_TOL`` of the inputs' dtype. Returns (max abs error, rms of
    the twin's output, the largest error as a share of its limit)."""
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = flash_attention(q, k, v, causal=causal, window=window)
    _require(got.dtype == q.dtype and got.shape == q.shape,
             f"{name}: output {got.dtype} {tuple(got.shape)}")
    atol, rtol = tol or FLASH_TOL[q.dtype]
    d = (got.float() - want.float()).abs()
    err = float(d.max())
    rms = float(want.float().square().mean().sqrt())
    share = float((d / (atol + rtol * want.float().abs())).max())
    _require(share <= 1.0,
             f"{name}: out of tolerance (max abs err {err}, output rms "
             f"{rms}, atol {atol}, rtol {rtol})")
    del want, d
    _require(torch.equal(flash_attention(q, k, v, causal=causal,
                                         window=window), got),
             f"{name}: two runs differ")
    return err, rms, share


def rglru_inputs(dev, shape, seed=0):
    """(a, b) of ``shape`` (B, S, W), float32 on ``dev``: a uniform on
    [0.2, 0.999), b normal with std 0.3 (the suite's draws)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(shape, device=dev, generator=g) * 0.799 + 0.2
    return a, torch.randn(shape, device=dev, generator=g) * 0.3


def check_rglru(name, a, b) -> float:
    """Run ``rglru_scan`` twice and hold it bitwise against
    ``rglru_scan_ref``. Returns the max abs error (0.0)."""
    want = ref.rglru_scan_ref(a, b)
    got = rglru_scan(a, b)
    _require(torch.equal(got, want), f"{name}: not bitwise equal (max abs "
             f"err {float((got - want).abs().max())})")
    _require(torch.equal(rglru_scan(a, b), got), f"{name}: two runs differ")
    return 0.0


def serve_sweep(dev) -> tuple[int, dict]:
    """``flash_attention`` over ``FLASH_SHAPES`` x ``FLASH_MASKS`` x
    ``FLASH_DTYPES`` within ``FLASH_TOL`` and at the ``FLASH_SERVE``
    shapes within ``FLASH_SERVE_TOL``, ``rglru_scan`` over
    ``RGLRU_SHAPES``, ``rwkv6_scan`` by :func:`rwkv6_sweep`. Returns
    (number of cases, max abs error per kernel and dtype, per serving
    shape its max abs error, output rms and largest share of its limit,
    and per rwkv6_scan case its errors against the float64 recurrence,
    the kernel's and the plain version's)."""
    err = {"flash_attention/float32": 0.0, "flash_attention/bfloat16": 0.0,
           "rglru_scan": 0.0}
    n = 0
    for sh in FLASH_SHAPES:
        for c, w in FLASH_MASKS:
            for dt in FLASH_DTYPES:
                q, k, v = flash_inputs(dev, sh, dt, seed=n)
                key = f"flash_attention/{str(dt).split('.')[1]}"
                e, _, _ = check_flash(
                    "flash_attention/B{}S{}H{}K{}D{}".format(*sh)
                    + f"-c{int(c)}w{w}", q, k, v, causal=c, window=w)
                err[key] = max(err[key], e)
                n += 1
    for arch, (sh, c, w) in FLASH_SERVE.items():
        q, k, v = flash_inputs(dev, sh, torch.bfloat16, seed=n)
        e, rms, share = check_flash(f"flash_attention/{arch}", q, k, v,
                                    causal=c, window=w, tol=FLASH_SERVE_TOL)
        err["flash_attention/bfloat16"] = max(
            err["flash_attention/bfloat16"], e)
        err[f"flash_attention/{arch}"] = {"max_abs_err": e, "rms": rms,
                                          "share_of_limit": share}
        n += 1
    del q, k, v
    for shape in RGLRU_SHAPES:
        a, b = rglru_inputs(dev, shape, seed=n)
        err["rglru_scan"] = max(err["rglru_scan"], check_rglru(
            "rglru_scan/B{}S{}W{}".format(*shape), a, b))
        n += 1
    del a, b
    n_rwkv, err_rwkv = rwkv6_sweep(dev)
    err.update(err_rwkv)
    return n + n_rwkv, err


#: rwkv6_scan's cases: (batch, sequence, heads, head dim), the dtype of
#: r / k / v, u given as (H*n,) or (H, n), and the decay law ("suite":
#: the JAX suite's clip(-exp(N(0, 1)), -5, -1e-5); "model":
#: ``init_rwkv``'s w0 ramp; "steep": clip(-exp(N(0, 1) + 2), -30,
#: -1e-5), past the model's clip, so that most chunks take the kernel's
#: sequential branch; "mixed": the steep law in every other 48 steps and
#: the suite's in between, so that the kernel switches branch with the
#: state in flight). The suite's three shapes (tests/test_kernels.py), a
#: ragged sequence, bf16 inputs, the steep and mixed laws (ragged too),
#: sequences shorter than a chunk, and rwkv6-7b's serving prefill (B 4,
#: S 2048, 64 heads of 64)
RWKV6_CASES = [((2, 64, 4, 32), torch.float32, "flat", "suite"),
               ((1, 100, 2, 64), torch.float32, "flat", "suite"),
               ((1, 48, 1, 16), torch.float32, "flat", "suite"),
               ((2, 37, 4, 32), torch.float32, "heads", "suite"),
               ((2, 64, 4, 64), torch.bfloat16, "heads", "model"),
               ((2, 100, 2, 64), torch.float32, "flat", "steep"),
               ((1, 200, 2, 32), torch.float32, "heads", "mixed"),
               ((3, 13, 2, 16), torch.float32, "heads", "steep"),
               ((1, 1, 2, 64), torch.bfloat16, "flat", "model")]
RWKV6_SERVE = ((4, 2048, 64, 64), torch.bfloat16, "flat", "model")
#: (atol, rtol), the JAX suite's
RWKV6_TOL = (2e-5, 2e-5)


def rwkv6_inputs(dev, shape, dtype, u_shape="flat", decay="suite", seed=0):
    """(r, k, v, log_w, u) on ``dev``: r, k, v standard normal x 0.5 (the
    suite's draws) rounded to ``dtype``; log_w float32, by the suite's
    law or, for ``decay="model"``, clip(-exp(w0 + dw), -5, -1e-5) with
    ``init_rwkv``'s w0 ramp from -6 to 2 over the H * n channels and dw
    normal x 0.5, so the slowest channels remember about 400 steps, or,
    for ``decay="steep"``, clip(-exp(z + 2), -30, -1e-5), and for
    ``decay="mixed"`` that law on steps 48..95, 144..191, ... and
    clip(-exp(z), -30, -1e-5) elsewhere; u float32 normal x 0.1, (H*n,)
    or (H, n)."""
    b, s, h, n = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(shape, device=dev, generator=g).mul(0.5)
               .to(dtype) for _ in range(3))
    z = torch.randn(shape, device=dev, generator=g)
    if decay == "model":
        ramp = torch.arange(h * n, dtype=torch.float32, device=dev) \
            / max(h * n - 1, 1)
        w0 = (-6.0 + 8.0 * ramp ** 3).reshape(h, n)
        log_w = -torch.exp(w0 + 0.5 * z)
    elif decay in ("steep", "mixed"):
        steep = torch.ones(s, dtype=torch.bool, device=dev)
        if decay == "mixed":
            steep = torch.arange(s, device=dev) // 48 % 2 == 1
        log_w = -torch.exp(z + 2.0 * steep.reshape(1, s, 1, 1))
    else:
        log_w = -torch.exp(z)
    log_w = torch.clamp(log_w, -5.0 if decay in ("suite", "model")
                        else -30.0, -1e-5)
    u = torch.randn(h * n, device=dev, generator=g) * 0.1
    return r, k, v, log_w, (u if u_shape == "flat" else u.reshape(h, n))


def check_rwkv6(name, r, k, v, log_w, u) -> dict:
    """Run ``rwkv6_scan`` twice and hold it within ``RWKV6_TOL`` of the
    recurrence evaluated in float64; two runs must agree bitwise. Returns
    the kernel's max abs error and largest share of its limit, and the
    same two for the float32 plain version against the same yardstick
    (reported, not gated)."""
    exact = ref.rwkv6_scan_ref(r, k, v, log_w, u, dtype=torch.float64)
    got = rwkv6_scan(r, k, v, log_w, u)
    _require(got.dtype == torch.float32 and got.shape == exact.shape,
             f"{name}: output {got.dtype} {tuple(got.shape)}")
    atol, rtol = RWKV6_TOL
    lim = atol + rtol * exact.abs()
    d = (got.double() - exact).abs()
    out = {"max_abs_err": float(d.max()),
           "share_of_limit": float((d / lim).max())}
    _require(bool((d <= lim).all()),
             f"{name}: out of tolerance of the float64 recurrence (max abs "
             f"err {out['max_abs_err']}, share {out['share_of_limit']}, "
             f"atol {atol}, rtol {rtol})")
    del d
    _require(torch.equal(rwkv6_scan(r, k, v, log_w, u), got),
             f"{name}: two runs differ")
    d = (ref.rwkv6_scan_ref(r, k, v, log_w, u).double() - exact).abs()
    out.update(plain_max_abs_err=float(d.max()),
               plain_share_of_limit=float((d / lim).max()))
    return out


def rwkv6_sweep(dev) -> tuple[int, dict]:
    """``rwkv6_scan`` over ``RWKV6_CASES`` and at ``RWKV6_SERVE``. Returns
    (number of cases, {"rwkv6_scan": the kernel's max abs error over all
    cases, "rwkv6_scan/plain": the float32 plain version's, and per case
    :func:`check_rwkv6`'s numbers})."""
    err = {"rwkv6_scan": 0.0, "rwkv6_scan/plain": 0.0}
    for i, (shape, dt, ush, decay) in enumerate(RWKV6_CASES + [RWKV6_SERVE]):
        name = "rwkv6_scan/B{}S{}H{}N{}".format(*shape) \
            + f"-{str(dt).split('.')[1]}-u{ush}-{decay}"
        e = check_rwkv6(name, *rwkv6_inputs(dev, shape, dt, ush, decay,
                                            seed=i))
        err[name] = e
        err["rwkv6_scan"] = max(err["rwkv6_scan"], e["max_abs_err"])
        err["rwkv6_scan/plain"] = max(err["rwkv6_scan/plain"],
                                      e["plain_max_abs_err"])
    return len(RWKV6_CASES) + 1, err
