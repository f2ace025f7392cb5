"""The arithmetic of ``csrc/rwkv6_scan.cu`` on the CPU: a plain PyTorch
emulation of the kernel's factorization, held within the JAX suite's
rtol / atol 2e-5 of the WKV6 recurrence evaluated in float64
(``ref.rwkv6_scan_ref(..., dtype=torch.float64)``), the yardstick the
card check holds the kernel to.

The emulation follows the kernel step for step: chunks of 16 steps, the
in-chunk cumulative log-decay L summed in float32 in step order, the
factors rd = r e^{L_{t-1} - L_7}, kd = k e^{L_7 - L_s}, ra = rd e^{L_7}
and ks = kd e^{L_C - L_7} (ks = k at the chunk's last step), with the
state's decay e^{L_C} taken in float64 and rounded once, the masked
scores with the bonus on the diagonal,
every product in 3xTF32 (``cvt.rna``: round to 10 mantissa bits, ties
away from zero; a bf16 operand exact and taken in two passes), the state
updated with one rounding a chunk (fmaf), and the sequential float32
branch for chunks whose half-chunk decays pass 64. Only the order of
each product's float32 sums differs from the kernel's. The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import card_check as cc  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

C, MID, STEEP = 16, 7, 64.0
ATOL, RTOL = cc.RWKV6_TOL
# (B, S, H, n), dtype of r / k / v, decay law: the suite's shapes, a
# ragged sequence, bf16 with the model's decay, a serving-like prefill
# (eight of rwkv6-7b's heads, a 2048 prompt), the steep law, the mixed
# one (steep in every other 48 steps), and sequences shorter than a chunk
CASES = [((2, 64, 4, 32), torch.float32, "suite"),
         ((1, 100, 2, 64), torch.float32, "suite"),
         ((1, 48, 1, 16), torch.float32, "suite"),
         ((2, 37, 4, 32), torch.float32, "suite"),
         ((2, 64, 4, 64), torch.bfloat16, "model"),
         ((1, 2048, 8, 64), torch.bfloat16, "model"),
         ((2, 100, 2, 64), torch.float32, "steep"),
         ((1, 200, 2, 32), torch.float32, "mixed"),
         ((3, 13, 2, 16), torch.float32, "steep"),
         ((1, 1, 2, 64), torch.bfloat16, "model")]


def wkv_inputs(shape, dtype, decay, seed):
    """card_check's laws, drawn with numpy: r, k, v normal x 0.5 in
    ``dtype``; log_w float32 by the suite's law clip(-exp(z), -5, -1e-5),
    the model's w0 ramp clip(-exp(w0 + z / 2), -5, -1e-5), the steep
    clip(-exp(z + 2), -30, -1e-5) or, mixed, the steep law on steps
    48..95, 144..191, ... and clip(-exp(z), -30, -1e-5) elsewhere; u
    normal x 0.1."""
    rng = np.random.default_rng(seed)
    b, s, h, n = shape
    r, k, v, z = (rng.standard_normal(shape, dtype=np.float32)
                  for _ in range(4))
    if decay == "model":
        ramp = np.arange(h * n, dtype=np.float32) / max(h * n - 1, 1)
        w0 = (-6.0 + 8.0 * ramp ** 3).reshape(h, n)
        log_w = np.clip(-np.exp(w0 + 0.5 * z), -5.0, -1e-5)
    elif decay in ("steep", "mixed"):
        steep = np.ones(s, dtype=bool)
        if decay == "mixed":
            steep = np.arange(s) // 48 % 2 == 1
        log_w = np.clip(-np.exp(z + 2.0 * steep.reshape(1, s, 1, 1)),
                        -30.0, -1e-5)
    else:
        log_w = np.clip(-np.exp(z), -5.0, -1e-5)
    u = rng.standard_normal(h * n, dtype=np.float32) * 0.1
    return (*(torch.from_numpy(0.5 * t).to(dtype) for t in (r, k, v)),
            torch.from_numpy(log_w.astype(np.float32)), torch.from_numpy(u))


def tf32(x):
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, ties
    away from zero (add half the dropped 13 bits' weight to the
    magnitude, then clear them)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def exp_rn(x):
    """exp in float64, rounded once to float32."""
    return torch.exp(x.double()).float()


def mm(a, b, *, a_exact=False, b_exact=False, passes=3):
    """a @ b as the kernel's mma.sync passes: lo x hi, hi x lo, hi x hi,
    float32 accumulators; an exact (bf16) operand has no lo part;
    ``passes=1`` takes hi x hi alone (plain TF32)."""
    ah = a if a_exact else tf32(a)
    bh = b if b_exact else tf32(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    if passes == 3:
        if not a_exact:
            out = out + (tf32(a - ah) @ bh)
        if not b_exact:
            out = out + (ah @ tf32(b - bh))
    return out + ah @ bh


def wkv_chunked(r, k, v, log_w, u, passes=3):
    """The kernel's arithmetic. r, k, v, log_w: (B, S, H, n); u: (H*n,).
    Returns ((B, S, H, n) float32, chunks that took the steep branch)."""
    b, s, h, n = r.shape
    exact_v = v.dtype == torch.bfloat16
    pad = (-s) % C
    rf, kf, vf, lw = (torch.nn.functional.pad(
        t.float().permute(0, 2, 1, 3), (0, 0, 0, pad))
        for t in (r, k, v, log_w))          # (B, H, S', n), identity steps
    uh = u.float().reshape(1, h, 1, n)
    S = torch.zeros((b, h, n, n))           # [key i, value j]
    out = torch.empty_like(rf)
    lower = torch.tril(torch.ones(C, C, dtype=torch.bool), -1)
    eye = torch.eye(C, dtype=torch.bool)
    n_steep = 0
    for c0 in range(0, s + pad, C):
        rc, kc, vc, wc = (t[:, :, c0:c0 + C] for t in (rf, kf, vf, lw))
        L = torch.empty_like(wc)
        acc = torch.zeros_like(wc[:, :, 0])
        for t in range(C):
            acc = acc + wc[:, :, t]
            L[:, :, t] = acc
        Lm, LC = L[:, :, MID:MID + 1], L[:, :, C - 1:]
        Lp = torch.cat([torch.zeros_like(Lm), L[:, :, :-1]], dim=2)
        steep = ((Lm < -STEEP) | (L[:, :, C - 2:C - 1] - Lm < -STEEP)) \
            .flatten(2).any(-1)             # (B, H): one flag a block
        bonus = (rc * uh * kc).sum(-1)      # (B, H, C)
        rd = rc * torch.exp(Lp - Lm)
        kd = kc * torch.exp(Lm - L)
        kd[:, :, C - 1] = 0.0
        ra = rd * torch.exp(Lm)
        ks = kd * torch.exp(LC - Lm)
        ks[:, :, C - 1] = kc[:, :, C - 1]
        A = mm(rd, kd.transpose(-1, -2), passes=passes)
        A = torch.where(lower, A, torch.where(eye, bonus[..., None], 0.0))
        y = mm(A, vc, b_exact=exact_v, passes=passes) \
            + mm(ra, S, passes=passes)
        delta = mm(ks.transpose(-1, -2), vc, b_exact=exact_v, passes=passes)
        S_next = (S.double() * exp_rn(LC).transpose(-1, -2).double()
                  + delta.double()).float()
        if steep.any():
            n_steep += int(steep.sum())
            Ss = S[steep]
            ys = torch.empty_like(rc[steep])
            for t in range(C):
                rt, kt, vt = (x[steep][:, t] for x in (rc, kc, vc))
                ys[:, t] = torch.einsum("ei,eij->ej", rt, Ss) \
                    + bonus[steep][:, t, None] * vt
                Ss = torch.exp(wc[steep][:, t])[..., None] * Ss \
                    + kt[..., None] * vt[:, None, :]
            y[steep] = ys
            S_next[steep] = Ss
        out[:, :, c0:c0 + C] = y
        S = S_next
    return out[:, :, :s].permute(0, 2, 1, 3), n_steep


def share_of_limit(got, exact):
    """The largest |got - exact| as a share of atol + rtol |exact|."""
    return float(((got.double() - exact).abs()
                  / (ATOL + RTOL * exact.abs())).max())


@pytest.mark.parametrize("shape,dtype,decay", CASES,
                         ids=lambda v: ("B{}S{}H{}N{}".format(*v)
                                        if isinstance(v, tuple)
                                        else str(v).replace("torch.", "")))
def test_chunked_arithmetic_within_tolerance_of_float64(shape, dtype, decay):
    wkv = wkv_inputs(shape, dtype, decay, seed=sum(shape))
    exact = ref.rwkv6_scan_ref(*wkv, dtype=torch.float64)
    got, n_steep = wkv_chunked(*wkv)
    assert got.dtype == torch.float32 and got.shape == exact.shape
    assert share_of_limit(got, exact) <= 1.0
    # the model's and the suite's decays never leave the factored form;
    # the steep law takes the sequential branch in most chunks, the mixed
    # one in some
    n_chunks = shape[0] * shape[2] * -(-shape[1] // C)
    if decay == "steep":
        assert n_steep >= n_chunks // 2
    elif decay == "mixed":
        assert 0 < n_steep < n_chunks
    else:
        assert n_steep == 0


def test_one_tf32_pass_is_far_outside():
    """The tolerance has teeth: the same factorization with each product
    in a single TF32 pass misses the float64 recurrence by far."""
    wkv = wkv_inputs((1, 256, 4, 64), torch.bfloat16, "model", seed=3)
    exact = ref.rwkv6_scan_ref(*wkv, dtype=torch.float64)
    assert share_of_limit(wkv_chunked(*wkv, passes=1)[0], exact) > 10.0
    assert share_of_limit(wkv_chunked(*wkv)[0], exact) <= 1.0


def test_plain_version_in_float64():
    """``rwkv6_scan_ref``'s ``dtype``: float64 out, the same recurrence as
    the float32 default, which stays float32."""
    wkv = wkv_inputs((2, 40, 2, 16), torch.float32, "suite", seed=1)
    f32 = ref.rwkv6_scan_ref(*wkv)
    f64 = ref.rwkv6_scan_ref(*wkv, dtype=torch.float64)
    assert f32.dtype == torch.float32 and f64.dtype == torch.float64
    assert share_of_limit(f32, f64) <= 1.0
    # and float64 is the exact recurrence: one step by hand
    r, k, v, lw, u = (t.double() for t in wkv)
    y0 = (r[:, 0] * u.reshape(2, 16) * k[:, 0]).sum(-1, keepdim=True) \
        * v[:, 0]
    s1 = k[:, 0, :, :, None] * v[:, 0, :, None, :]
    y1 = torch.einsum("bhi,bhij->bhj", r[:, 1],
                      s1 + u.reshape(2, 16)[None, :, :, None]
                      * k[:, 1, :, :, None] * v[:, 1, :, None, :])
    torch.testing.assert_close(f64[:, 0], y0, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(f64[:, 1], y1, rtol=1e-12, atol=1e-12)
