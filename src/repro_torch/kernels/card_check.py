"""Each kernel against its plain version, on the card: the shape sweep,
the input builder and the comparison that ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` both run.

Criteria: mode "none" planes and every state plane bitwise equal to the
plain version (the kernels build with -fmad=false, so each product and
sum rounds as PyTorch's separate eager ops do); mean / group planes
within rtol 1e-6 / atol 1e-7 on f32 columns and one dtype ulp on
bf16/f16 columns; dispersion rtol 1e-5; two runs bitwise identical (no
atomics). A failed check raises ``AssertionError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.avg_disp import avg_disp
from repro_torch.kernels.opt_step import opt_step

# (M, P, groups of mode "group"): ragged P against the 1024-column
# block, every register-array size M rounds up to (4, 8, 32, 64), and
# (24, 1024) is the paper's least-squares plane on the f32 main path.
SHAPES = [(4, 1000, 2), (8, 2500, 4), (24, 1024, 4), (64, 333, 8)]
# avg_disp group counts, each dividing every M above; 4 is the
# hierarchical inner event of the f32 main path.
AVG_GROUPS = (1, 2, 4)
OPTS = {"sgd": ("sgd", {}), "momentum": ("momentum", {"mu": 0.9}),
        "nesterov": ("momentum", {"mu": 0.9, "nesterov": True}),
        "adamw": ("adamw", {"b1": 0.9, "b2": 0.95, "eps": 1e-8,
                            "weight_decay": 0.01})}
NSTATE = {"sgd": 0, "momentum": 1, "adamw": 2}


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
    err = max_err(name, got_x, want_x, codes, exact=kw["mode"] == "none")
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


def check_avg_disp(name, x, groups) -> float:
    """Run ``avg_disp`` twice and hold it against ``avg_disp_ref``.
    Returns the max abs error of the plane."""
    want, want_d = ref.avg_disp_ref(x, groups=groups)
    got, got_d = avg_disp(x, groups=groups)
    err = max_err(name, got, want)
    del want
    _require(math.isclose(float(got_d), float(want_d), rel_tol=1e-5),
             f"{name}: dispersion {float(got_d)} vs plain {float(want_d)}")
    got2, d2 = avg_disp(x, groups=groups)
    _require(torch.equal(got2, got) and float(d2) == float(got_d),
             f"{name}: two runs differ")
    return err


def sweep(dev) -> tuple[int, dict]:
    """Every (shape, optimizer, mode, codes) case of ``opt_step`` and
    every (shape, groups) case of ``avg_disp``. Returns (number of cases,
    max abs error per kernel)."""
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
            x = make_inputs(dev, m, p, "sgd", seed=1000 + grp)[0]
            e = check_avg_disp(f"avg_disp/g{grp}-M{m}P{p}", x, grp)
            err["avg_disp"] = max(err["avg_disp"], e)
            n += 1
    return n, err
