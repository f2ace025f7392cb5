#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line:
  1. card + build: the device, ``nvidia-smi`` name and power limit, and
     the build of every CUDA kernel under src/repro_torch/kernels/csrc/;
     the bf16 flash kernel's (``flash_fwd_wgmma``) registers and spills
     per head dim, none allowed at 64 and 256, and its ``HGMMA``
     (tensor-core) instructions counted in the SASS by ``cuobjdump``
     where the toolkit or Triton has one, each head dim needing some; the
     same for ``rwkv6_scan``'s ``rwkv6_chunk_mma`` per head dim and input
     type (no spills at 64, TF32 ``HMMA`` in each instantiation);
  2. kernels vs plain: ``opt_step`` (modes none / mean / group / mix and
     the wire path), ``avg_disp``, ``mix_disp``, ``avg_disp_outer`` and
     ``compressed_mix`` against their plain PyTorch versions over the
     sweep of ``repro_torch.kernels.card_check`` and at full width (M=4
     workers x P=361,821,120, smollm-360m), bitwise reproducible across
     two runs, timed with CUDA events beside their memory bound; then
     ``flash_attention``, ``rglru_scan`` and ``rwkv6_scan`` over
     card_check's serving sweep (the JAX suite's shapes in float32 and
     bfloat16, and the serving shapes) and timed at the serving shapes
     beside their bounds, their plain versions and, for flash attention,
     ``scaled_dot_product_attention`` (the backend that ran is named),
     with both achieved TFLOP/s and the kernel's share of its bound;
     ``rwkv6_scan`` is held to the recurrence evaluated in float64, its
     error reported beside the float32 plain version's own;
  3. the main path at full width: ``repro_torch.launch.train`` trains
     smollm-360m (bf16, 4 workers, Momentum) — periodic K=2, minibatch,
     minibatch over a ring (``opt_step`` mode mix), periodic K=2 over a
     ring with the one_bit wire (``compressed_mix``), and minibatch with
     the bf16 wire (the ``opt_step`` wire path);
  4. the f32 path: the paper's least-squares ``synth-ls-sparse-highrho``
     (4096 x 1024, 24 workers, SGD on lr0 / (t - 1 + d)) under periodic,
     hierarchical, ring and gossip-pairs (``mix_disp``), stochastic,
     int8 (``compressed_mix``), minibatch over a torus with int8
     (``opt_step`` mix + wire) and the outer optimizer
     (``avg_disp_outer``); then small runs on the card and on the CPU
     (the kernels' plain versions), which must agree;
  5. serving at full width (``repro_torch.launch.serve``, bf16, random
     weights): recurrentgemma-2b, batch 4, a prompt of 3072 (beyond its
     2048 window), 32 tokens generated — the prefill launches
     ``flash_attention`` 8 times and ``rglru_scan`` 18 times, decode
     neither; smollm-360m, batch 4, a prompt of 2048, 32 generated — 32
     ``flash_attention`` launches; rwkv6-7b, batch 4, a prompt of 2048,
     32 generated — its cache-capturing prefill takes the chunked WKV and
     launches no kernel, as the reference's does, and its cacheless
     prefill step (``steps.make_prefill_step``) launches ``rwkv6_scan``
     32 times, timed and held against the serve prefill's last logits
     (reported, not gated); prefill ms, decode ms per token, tokens/s and
     peak memory; the kernel path against ``impl="plain"`` on the card
     where the serve prefill launches a kernel (reported, not gated);
     and the serve CLI once;
  6. summary: a ``kernels`` line over all eight kernels, the card, then
     ``{"ok": true, "device": ...}`` as the last line.

Every launch count is set to 0 just before a main-path run (phases 3-5)
and read just after; the ``kernels`` line sums those runs. Any failed
check raises, so the script exits non-zero without the ``ok`` line; it
also refuses to run without a CUDA device. All of its work happens under
``if __name__ == "__main__"``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM, bf16 tensor cores, dense
FULL_M, FULL_P = 4, 361_821_120
NSTATE = {"sgd": 0, "momentum": 1, "adamw": 2}
# the serving runs of phase 5: batch, prompt length, tokens generated,
# each serve prefill's kernel launches and, where given, those of the
# cacheless prefill step
SERVE = {"recurrentgemma-2b": dict(batch=4, prompt=3072, gen=32,
                                   launches={"flash_attention": 8,
                                             "rglru_scan": 18}),
         "smollm-360m": dict(batch=4, prompt=2048, gen=32,
                             launches={"flash_attention": 32}),
         "rwkv6-7b": dict(batch=4, prompt=2048, gen=32, launches={},
                          step_launches={"rwkv6_scan": 32})}
# rglru_scan at recurrentgemma-2b's prefill: batch, sequence, rnn width
RGLRU = dict(b=4, s=3072, w=2560)
# rwkv6_scan at rwkv6-7b's prefill: batch, sequence, heads, head dim
RWKV6 = dict(b=4, s=2048, h=64, n=64)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound_ms(nbytes: float, flops: float,
             peak: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def steady_step_ms(phase_wall) -> float:
    """ms per step over every phase but the first, which warms up."""
    steady = phase_wall[1:]
    return 1e3 * sum(w for *_, w in steady) / sum(
        t1 - t0 + 1 for t0, t1, _ in steady)


# ---- cost of each kernel's work: (bytes, flops), each input read once and
#      each output written once --------------------------------------------

def opt_step_cost(m, p, kind, has_codes, mix=False):
    """x, g and the S state planes read once, the codes row read once, x
    and the state planes written once (mode mix: W too); per element the
    update (sgd 2, momentum 4, adamw 14 flops) plus 4 for the column sum
    and the dispersion term, plus 2M for a mix."""
    s = NSTATE[kind]
    nbytes = (2 + s) * m * p * 4 + (p * 4 if has_codes else 0) \
        + (1 + s) * m * p * 4 + (m * m * 4 if mix else 0)
    per = {"sgd": 2, "momentum": 4, "adamw": 14}[kind] + 4 \
        + (2 * m if mix else 0)
    return nbytes, per * m * p


def avg_disp_cost(m, p):
    """(bytes, flops): the plane read once, the output written once; a
    sum, a difference, a square and an add per element."""
    return 2 * m * p * 4, 4 * m * p


def mix_disp_cost(m, p):
    """The plane and W read once, the mixed plane written once; 2M flops
    of the mix and 4 of the dispersion per element."""
    return 2 * m * p * 4 + m * m * 4, (2 * m + 4) * m * p


def avg_disp_outer_cost(m, p):
    """The plane, prev and vel read once; the plane, new and vel' written
    once; 4 flops per element and 7 per column for the momentum step."""
    return 2 * m * p * 4 + 4 * p * 4, 4 * m * p + 7 * p


def compressed_cost(m, p, wire, has_codes, mix=False):
    """The plane and the residual read and written once, the uniforms
    (int8) and the codes row read once; per element the encode (bf16 2,
    int8 6, one_bit 3 flops), the residual 1, the event (1, or 2M for a
    mix) and the dispersion 4."""
    planes = 4 + (1 if wire == "int8" else 0)
    nbytes = planes * m * p * 4 + (p * 4 if has_codes else 0) \
        + (m * m * 4 if mix else 0)
    per = {"bf16": 2, "int8": 6, "one_bit": 3}[wire] + 1 \
        + (2 * m if mix else 1) + 4
    return nbytes, per * m * p


def opt_step_wire_cost(m, p, kind, wire, has_codes, mix=False):
    """The update's inputs and outputs (``opt_step_cost``) plus the
    residual read and written and the uniforms read (int8); flops of the
    update and of the compressed event."""
    nb, fl = opt_step_cost(m, p, kind, has_codes, mix)
    cb, cf = compressed_cost(m, p, wire, False)
    return nb + cb - 2 * m * p * 4, fl + cf


def band_pairs(s, causal, window):
    """(query, key) pairs of one (batch, head) that the mask keeps: key <
    s, key <= query when ``causal``, key > query - window when
    ``window`` > 0."""
    n = 0
    for qpos in range(s):
        hi = qpos + 1 if causal else s
        lo = max(0, qpos - window + 1) if window > 0 else 0
        n += hi - lo
    return n


def attention_cost(b, s, h, hkv, hd, causal, window):
    """q, k, v read once and the output written once, in bf16; QKᵀ and PV:
    2 * 2 * b * h * hd flops per (query, key) pair of the band."""
    nbytes = (2 * b * s * h * hd + 2 * b * s * hkv * hd) * 2
    return nbytes, 4 * b * h * hd * band_pairs(s, causal, window)


def rglru_cost(b, s, w):
    """a and b read once and h written once, in f32; a multiply and an
    add per element."""
    return 3 * b * s * w * 4, 2 * b * s * w


def rwkv6_cost(b, s, h, n):
    """r, k and v read once in bf16, the log-decays (float32, as the
    model's ``_project`` gives them) and u once in f32, the output written
    once in f32. Per (token, head) the least work is 5n² + 5n flops: r·S
    (2n²) and the state update w∘S + k vᵀ (3n²); the bonus factors out as
    y_j += v_j (r·(u∘k)), 3n for the scalar and 2n to add it in."""
    e = b * s * h * n
    return 3 * e * 2 + e * 4 + h * n * 4 + e * 4, 5 * e * n + 5 * e


def cuobjdump_path(nvcc: str):
    """``cuobjdump`` from the CUDA toolkit beside ``nvcc``, on PATH, or in
    Triton's package (``triton/backends/nvidia/bin``); None if none."""
    import shutil
    cands = [Path(nvcc).parent / "cuobjdump", shutil.which("cuobjdump")]
    try:
        import triton
        cands.append(Path(triton.__file__).parent / "backends" / "nvidia"
                     / "bin" / "cuobjdump")
    except ImportError:
        pass
    return next((str(c) for c in cands if c and Path(c).exists()), None)


def sass_counts(tool: str, lib: Path, *needles: str) -> dict:
    """How many instructions holding every one of ``needles`` (an opcode
    and its modifiers) each kernel of ``lib`` has in its SASS
    (``cuobjdump -sass``), by mangled kernel name."""
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :", 1)[1].strip()
            counts[cur] = 0
        elif cur is not None and all(x in ln for x in needles):
            counts[cur] += 1
    return counts


def rwkv6_kernels(names) -> dict:
    """{"<head dim>-<bf16|f32>": mangled name} of the WKV kernels
    (``rwkv6_chunk_mma<n, In>``) among ``names``."""
    import re
    out = {}
    for n in names:
        m = re.search(r"rwkv6_chunk_mmaILi(\d+)E(13__nv_bfloat16|f)E", n)
        if m:
            dt = "f32" if m.group(2) == "f" else "bf16"
            out[f"{m.group(1)}-{dt}"] = n
    return out


def flash_kernels(names) -> dict:
    """{head dim: mangled name} of the bf16 tensor-core flash kernels
    (``flash_fwd_wgmma<hd>``) among ``names``."""
    import re
    out = {}
    for n in names:
        m = re.search(r"flash_fwd_wgmmaILi(\d+)E", n)
        if m:
            out[int(m.group(1))] = n
    return out


def sdpa_time(q, k, v, cuda_time, *, causal, window):
    """The library's yardstick for flash attention, timed but never used
    by the port: ``scaled_dot_product_attention`` on the same inputs (the
    key / value heads repeated to the query heads, the window as a
    boolean band mask), under the first backend that takes them. Returns
    (ms, backend name, max |SDPA - flash_attention|)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import flash_attention
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(g, dim=2).transpose(1, 2) for t in (k, v))
    kw = {"is_causal": causal}
    if window > 0:
        pos = torch.arange(q.shape[1], device=q.device)
        band = pos[None, :] > pos[:, None] - window
        if causal:
            band &= pos[None, :] <= pos[:, None]
        kw = {"attn_mask": band}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        with sdpa_kernel([backend]):
            ms = cuda_time(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **kw), 5)
        ours = flash_attention(q, k, v, causal=causal, window=window)
        diff = float((out.transpose(1, 2).float() - ours.float()).abs().max())
        return ms, backend.name, diff
    raise RuntimeError("no scaled_dot_product_attention backend took the "
                       "inputs")


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs only on a CUDA device")
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.kernels import card_check as cc
    from repro_torch.kernels import ref
    from repro_torch.kernels.avg_disp import (avg_disp, avg_disp_outer,
                                              compressed_mix, mix_disp)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.opt_step import opt_step
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    kernels = {"opt_step": opt_step, "avg_disp": avg_disp,
               "mix_disp": mix_disp, "avg_disp_outer": avg_disp_outer,
               "compressed_mix": compressed_mix,
               "flash_attention": flash_attention, "rglru_scan": rglru_scan,
               "rwkv6_scan": rwkv6_scan}
    main_launches = dict.fromkeys(kernels, 0)

    def zero_counts():
        for k in kernels.values():
            k.launches = 0

    def read_counts(expect: dict, what: str) -> dict:
        """The counts of the run just driven, held against ``expect``
        (kernels not named there must not have launched); added to the
        main path's totals."""
        got = {n: k.launches for n, k in kernels.items()}
        want = {n: expect.get(n, 0) for n in kernels}
        check(got == want, f"{what}: launches {got}, want {want}")
        for n, c in got.items():
            main_launches[n] += c
        return got

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    # ---- 1. card and build -------------------------------------------------
    print(smi, flush=True)
    t0 = time.perf_counter()
    info = _build.build_all()
    build_s = time.perf_counter() - t0
    # the bf16 flash kernel's resources per head dim, and its tensor-core
    # instructions in the SASS: wgmma compiles to HGMMA
    ptx_flash = {r["kernel"]: r for r in info["ptxas"]["flash_attention"]}
    flash_regs = {hd: {k: ptx_flash[n][k] for k in
                       ("registers", "spill_stores", "spill_loads")}
                  for hd, n in sorted(flash_kernels(ptx_flash).items())}
    check(sorted(flash_regs) == [32, 64, 128, 256],
          f"flash_fwd_wgmma head dims in ptxas: {sorted(flash_regs)}")
    for hd in (64, 256):
        check(flash_regs[hd]["spill_stores"] == 0
              and flash_regs[hd]["spill_loads"] == 0,
              f"flash_fwd_wgmma<{hd}> spills: {flash_regs[hd]}")
    tool = cuobjdump_path(_build.nvcc_path())
    hgmma = None
    if tool:
        counts = sass_counts(tool, _build._lib_path("flash_attention"),
                             "HGMMA")
        hgmma = {hd: counts.get(n, 0)
                 for hd, n in sorted(flash_kernels(counts).items())}
        check(sorted(hgmma) == [32, 64, 128, 256]
              and all(c > 0 for c in hgmma.values()),
              f"HGMMA in flash_fwd_wgmma's SASS: {hgmma}")
    # the same for the WKV kernel, per head dim and input type: its
    # products run as TF32 mma.sync, HMMA.1688.F32.TF32 in the SASS
    ptx_wkv = {r["kernel"]: r for r in info["ptxas"]["rwkv6_scan"]}
    wkv_names = rwkv6_kernels(ptx_wkv)
    wkv_regs = {key: {k: ptx_wkv[n][k] for k in
                      ("registers", "spill_stores", "spill_loads")}
                for key, n in sorted(wkv_names.items())}
    wkv_keys = sorted(f"{n}-{dt}" for n in (16, 32, 64)
                      for dt in ("bf16", "f32"))
    check(sorted(wkv_regs) == wkv_keys,
          f"rwkv6_chunk_mma instantiations in ptxas: {sorted(wkv_regs)}")
    for key in ("64-bf16", "64-f32"):
        check(wkv_regs[key]["spill_stores"] == 0
              and wkv_regs[key]["spill_loads"] == 0,
              f"rwkv6_chunk_mma<{key}> spills: {wkv_regs[key]}")
    wkv_hmma = None
    if tool:
        counts = sass_counts(tool, _build._lib_path("rwkv6_scan"), "HMMA",
                             "TF32")
        wkv_hmma = {key: counts.get(n, 0)
                    for key, n in sorted(rwkv6_kernels(counts).items())}
        check(sorted(wkv_hmma) == wkv_keys
              and all(c > 0 for c in wkv_hmma.values()),
              f"TF32 HMMA in rwkv6_chunk_mma's SASS: {wkv_hmma}")
    emit({"phase": "build", "device": kind_name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "built": info["built"],
          "flash_fwd_wgmma_ptxas": flash_regs,
          "flash_fwd_wgmma_hgmma": hgmma,
          "rwkv6_chunk_mma_ptxas": wkv_regs,
          "rwkv6_chunk_mma_tf32_hmma": wkv_hmma, "cuobjdump": tool,
          "ptxas": info.get("ptxas", {})})

    # ---- 2. kernels against their plain versions ---------------------------
    # the sweep and its criteria: repro_torch.kernels.card_check
    t0 = time.perf_counter()
    n_cases, err = cc.sweep(dev)
    sweep_s = time.perf_counter() - t0

    def cuda_time(fn, iters):
        """ms per call of ``fn`` with CUDA events, after one warm-up."""
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    full = {}

    def record(name, k_ms, p_ms, cost, peak=F32_FLOPS_PER_S, **extra):
        b_ms, b_by = bound_ms(*cost, peak=peak)
        full[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, bytes=cost[0], flops=cost[1],
                          **extra)

    x, g, st, scal, codes = cc.make_inputs(dev, FULL_M, FULL_P, "momentum",
                                           "bf16", seed=7, scale=1e-3)
    ring = cc.mixing_matrix("ring", FULL_M, dev)
    for mode in ("none", "mean", "mix"):
        kw = dict(kind="momentum", mu=0.9, mode=mode,
                  W=ring if mode == "mix" else None)
        e, disp = cc.check_opt_step(f"opt_step/full-momentum-bf16-{mode}",
                                    x, g, st, scal, codes, **kw)
        err["opt_step"] = max(err["opt_step"], e)
        free()
        xk, sk = x.clone(), tuple(s.clone() for s in st)
        k_ms = cuda_time(lambda: opt_step(xk, g, sk, scal, codes=codes,
                                          **kw), 10)
        del xk, sk
        free()
        p_ms = cuda_time(lambda: ref.opt_step_ref(x, g, st, scal,
                                                  codes=codes, **kw), 3)
        free()
        record(f"opt_step/{mode}", k_ms, p_ms,
               opt_step_cost(FULL_M, FULL_P, "momentum", True,
                             mix=mode == "mix"), disp=disp)
    # the opt_step wire path, bf16 wire (the main path's third new run)
    r = cc.wire_inputs(dev, FULL_M, FULL_P, seed=8, uniforms=False)[0]
    kw = dict(kind="momentum", mu=0.9, mode="mean", wire="bf16")
    e = cc.check_opt_step_wire("opt_step/full-wire-bf16-mean", x, g, st,
                               scal, codes, r, None, **kw)
    err["opt_step"] = max(err["opt_step"], e)
    free()
    xk, sk, rk = x.clone(), tuple(s.clone() for s in st), r.clone()
    k_ms = cuda_time(lambda: opt_step(xk, g, sk, scal, codes=codes,
                                      resid=rk, **kw), 10)
    del xk, sk, rk
    free()
    p_ms = cuda_time(lambda: ref.opt_step_ref(x, g, st, scal, codes=codes,
                                              resid=r, **kw), 3)
    free()
    record("opt_step/wire-bf16-mean", k_ms, p_ms,
           opt_step_wire_cost(FULL_M, FULL_P, "momentum", "bf16", True))
    del g, st
    free()

    def time_compressed(name, xin, rin, u, codes_in, **kw):
        e = cc.check_compressed(f"compressed_mix/full-{name}", xin, rin,
                                u=u, codes=codes_in, **kw)
        err["compressed_mix"] = max(err["compressed_mix"], e)
        free()
        xk, rk = xin.clone(), rin.clone()
        k_ms = cuda_time(lambda: compressed_mix(xk, rk, u=u, codes=codes_in,
                                                **kw), 10)
        del xk, rk
        free()
        ckw = dict(wire=kw["wire"], u=u, codes=codes_in)
        if kw["mode"] == "mix":
            p_ms = cuda_time(lambda: ref.compressed_mix_ref(
                xin, rin, kw["W"], **ckw), 3)
        else:
            p_ms = cuda_time(lambda: ref.compressed_avg_ref(
                xin, rin, **ckw), 3)
        free()
        record(f"compressed_mix/{name}", k_ms, p_ms,
               compressed_cost(FULL_M, FULL_P, kw["wire"],
                               codes_in is not None, kw["mode"] == "mix"))

    # one_bit over a ring with bf16 codes: the main path's event
    time_compressed("one_bit-mix-codes", x, r, None, codes, wire="one_bit",
                    mode="mix", W=ring)
    time_compressed("bf16-mean-codes", x, r, None, codes, wire="bf16",
                    mode="mean")
    del codes
    free()
    u = cc.wire_inputs(dev, FULL_M, FULL_P, seed=9)[1]
    time_compressed("int8-mean", x, r, u, None, wire="int8", mode="mean")
    del u, r
    free()

    for grp in (1, 2):
        e = cc.check_avg_disp(f"avg_disp/full-g{grp}", x, grp)
        err["avg_disp"] = max(err["avg_disp"], e)
        free()
        k_ms = cuda_time(lambda: avg_disp(x, groups=grp), 10)
        free()
        p_ms = cuda_time(lambda: ref.avg_disp_ref(x, groups=grp), 3)
        free()
        record(f"avg_disp/g{grp}", k_ms, p_ms, avg_disp_cost(FULL_M, FULL_P))

    e = cc.check_mix_disp("mix_disp/full-ring", x, ring)
    err["mix_disp"] = max(err["mix_disp"], e)
    free()
    k_ms = cuda_time(lambda: mix_disp(x, ring), 10)
    free()
    p_ms = cuda_time(lambda: ref.mix_disp_ref(x, ring), 3)
    free()
    # one PyTorch call for the mix (not the dispersion): W @ x in full f32
    lib_ms = cuda_time(lambda: torch.matmul(ring, x), 10)
    free()
    record("mix_disp/ring", k_ms, p_ms, mix_disp_cost(FULL_M, FULL_P),
           library_ms=lib_ms)

    gen = torch.Generator(device=dev).manual_seed(10)
    prev = torch.randn(FULL_P, device=dev, generator=gen)
    vel = torch.randn(FULL_P, device=dev, generator=gen) * 1e-2
    okw = dict(lr=1.0, momentum=0.5, nesterov=True)
    e = cc.check_avg_disp_outer("avg_disp_outer/full", x, prev, vel, **okw)
    err["avg_disp_outer"] = max(err["avg_disp_outer"], e)
    free()
    k_ms = cuda_time(lambda: avg_disp_outer(x, prev, vel, **okw), 10)
    free()
    p_ms = cuda_time(lambda: ref.avg_disp_outer_ref(x, prev, vel, **okw), 3)
    free()
    record("avg_disp_outer/nesterov", k_ms, p_ms,
           avg_disp_outer_cost(FULL_M, FULL_P))
    del x, prev, vel
    free()

    # the serving kernels: card_check's sweep, then each timed at its
    # serving shape beside its bound, its plain version and (flash
    # attention) scaled_dot_product_attention
    t0 = time.perf_counter()
    n_serve, serve_err = cc.serve_sweep(dev)
    serve_sweep_s = time.perf_counter() - t0
    err["flash_attention"] = max(serve_err["flash_attention/float32"],
                                 serve_err["flash_attention/bfloat16"])
    err["rglru_scan"] = serve_err["rglru_scan"]
    err["rwkv6_scan"] = serve_err["rwkv6_scan"]
    free()
    for arch, (shape, causal, window) in cc.FLASH_SERVE.items():
        q, k, v = cc.flash_inputs(dev, shape, torch.bfloat16, seed=11)
        fkw = dict(causal=causal, window=window)
        k_ms = cuda_time(lambda: flash_attention(q, k, v, **fkw), 5)
        p_ms = cuda_time(lambda: ref.flash_attention_ref(q, k, v, **fkw), 2)
        free()
        lib_ms, backend, lib_err = sdpa_time(q, k, v, cuda_time, **fkw)
        free()
        b_, s_, h_, hkv_, hd_ = shape
        cost = attention_cost(b_, s_, h_, hkv_, hd_, causal, window)
        record(f"flash_attention/{arch}", k_ms, p_ms, cost,
               peak=BF16_FLOPS_PER_S, library_ms=lib_ms,
               library=f"scaled_dot_product_attention ({backend})",
               library_max_abs_diff=lib_err,
               pairs_per_head=band_pairs(s_, causal, window),
               tflops=cost[1] / k_ms / 1e9,
               library_tflops=cost[1] / lib_ms / 1e9)
        row = full[f"flash_attention/{arch}"]
        row["bound_share"] = row["bound_ms"] / k_ms
        del q, k, v
        free()
    a, b = cc.rglru_inputs(dev, (RGLRU["b"], RGLRU["s"], RGLRU["w"]), seed=12)
    k_ms = cuda_time(lambda: rglru_scan(a, b), 10)
    p_ms = cuda_time(lambda: ref.rglru_scan_ref(a, b), 2)
    record("rglru_scan/recurrentgemma-2b", k_ms, p_ms, rglru_cost(**RGLRU))
    del a, b
    free()
    shape, dt, u_shape, decay = cc.RWKV6_SERVE
    check(shape == tuple(RWKV6.values()), f"rwkv6 shapes {shape}, {RWKV6}")
    wkv_in = cc.rwkv6_inputs(dev, shape, dt, u_shape, decay, seed=13)
    k_ms = cuda_time(lambda: rwkv6_scan(*wkv_in), 10)
    p_ms = cuda_time(lambda: ref.rwkv6_scan_ref(*wkv_in), 2)
    # the sweep's serving case against the float64 recurrence: the
    # kernel's error beside the float32 plain version's own
    vs64 = serve_err["rwkv6_scan/B{}S{}H{}N{}".format(*shape)
                     + f"-{str(dt).split('.')[1]}-u{u_shape}-{decay}"]
    record("rwkv6_scan/rwkv6-7b", k_ms, p_ms, rwkv6_cost(**RWKV6),
           vs_float64=vs64)
    full["rwkv6_scan/rwkv6-7b"]["bound_share"] = \
        full["rwkv6_scan/rwkv6-7b"]["bound_ms"] / k_ms
    del wkv_in
    free()
    emit({"phase": "kernels_vs_plain", "sweep_cases": n_cases,
          "serve_sweep_cases": n_serve, "sweep_s": sweep_s,
          "serve_sweep_s": serve_sweep_s, "max_abs_err": err,
          "serve_max_abs_err": serve_err,
          "flash_serve_tol": dict(zip(("atol", "rtol"), cc.FLASH_SERVE_TOL)),
          "rwkv6_tol": dict(zip(("atol", "rtol"), cc.RWKV6_TOL)),
          "full_width": {"M": FULL_M, "P": FULL_P, **full}, "card": smi})

    # ---- 3. the main path at full width (bf16 smollm-360m) ----------------
    from repro_torch.launch import train

    def train_run(argv, phase_len):
        """The CLI's run, with the loss recorded every step and phases of
        ``phase_len`` steps (None: the schedule's period), so that the
        first phase, which warms up, can be left out of the step time."""
        torch.cuda.reset_peak_memory_stats(dev)
        ap = train.make_parser()
        args = ap.parse_args(argv)
        _, engine, params, batches = train.setup(args, ap)
        zero_counts()
        t = time.perf_counter()
        final, hist, state = engine.run(
            params, batches(), num_workers=args.workers, seed=args.seed,
            record_every=1, phase_len=phase_len, return_state=True)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
        return final, hist, state, wall

    common = ["--arch", "smollm-360m", "--workers", "4", "--batch", "4",
              "--seq", "64", "--optimizer", "momentum", "--lr", "0.01",
              "--device", "cuda"]
    runs = {}
    for name, extra, phase_len, steps, events, expect in (
            ("periodic", ["--avg", "periodic", "--phase-len", "2"], None, 6,
             3, {"opt_step": 6}),
            ("minibatch", ["--avg", "minibatch"], 1, 2, 2, {"opt_step": 2}),
            ("minibatch-ring", ["--avg", "minibatch", "--topology", "ring"],
             1, 2, 2, {"opt_step": 2}),
            ("periodic-ring-one_bit",
             ["--avg", "periodic", "--phase-len", "2", "--topology", "ring",
              "--comm-dtype", "one_bit"], None, 4, 2,
             {"opt_step": 4, "compressed_mix": 2}),
            ("minibatch-bf16-wire", ["--avg", "minibatch", "--comm-dtype",
                                     "bf16"], 1, 2, 2,
             {"opt_step": 2, "compressed_mix": 2})):
        final, hist, state, wall = train_run(
            common + ["--steps", str(steps)] + extra, phase_len)
        got = read_counts(expect, name)
        losses = [v for _, v in hist["loss"]]
        check(len(losses) == steps and all(map(math.isfinite, losses)),
              f"{name}: losses {losses}")
        check(hist["averages"] == events,
              f"{name}: {hist['averages']} averaging ops, want {events}")
        plane = state.plane
        check(plane.shape == (FULL_M, FULL_P), f"plane {plane.shape}")
        on_grid = all(torch.equal(r, r.to(torch.bfloat16).float())
                      for r in plane)
        check(on_grid, f"{name}: plane left the bf16 grid")
        wire = "--comm-dtype" in extra
        check((state.resid is not None) == wire, f"{name}: residual plane")
        resid_abs_max = None
        if wire:
            check(all(bool(torch.isfinite(r).all()) for r in state.resid),
                  f"{name}: residual not finite")
            resid_abs_max = max(float(r.abs().max()) for r in state.resid)
        runs[name] = dict(steps=steps, averages=hist["averages"],
                          loss_first=losses[0], loss_last=losses[-1],
                          launches=got, step_ms=steady_step_ms(
                              hist["phase_wall"]),
                          wall_s=wall, resid_abs_max=resid_abs_max,
                          max_memory_gb=torch.cuda.max_memory_allocated(dev)
                          / 1e9)
        del final, hist, state, plane
        free()
    emit({"phase": "main_path_bf16", "arch": "smollm-360m",
          "params": FULL_P, "workers": FULL_M, **runs, "card": smi})

    # ---- 4. the f32 path: the paper's least squares ------------------------
    from repro_torch.configs import get_config
    from repro_torch.configs.paper import CONVEX_SUITE
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.core.averaging import OuterOptimizer
    from repro_torch.core.compress import Compression
    from repro_torch.data import convex_dataset, token_stream
    from repro_torch.models import init_params, lm_loss
    from repro_torch.optim import SGD, Momentum
    from repro_torch.topology import Topology

    c = CONVEX_SUITE[0]
    check(c.name == "synth-ls-sparse-highrho", c.name)
    mw = c.num_workers
    X, y, _ = convex_dataset(c.model, c.num_samples, c.num_dims,
                             sparsity=c.sparsity, noise=c.noise, seed=0)
    lr_d = 200.0
    lr0 = 0.8 * lr_d / float(np.mean(np.sum(X * X, axis=1)))
    opt = SGD(lr=lambda t: lr0 / (t - 1.0 + lr_d))
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)

    def ls_loss(p, b, r):
        return 0.5 * torch.square(b["x"] @ p["w"] - b["y"]), {}

    def objective(w):
        res = Xd @ w.to(dev) - yd
        return float(0.5 * torch.mean(res * res))

    def convex_run(sched, steps, device, **comm):
        idx = np.random.default_rng(1).integers(0, c.num_samples,
                                                (steps, mw))
        Xs, ys = Xd.to(device), yd.to(device)
        data = ({"x": Xs[idx[t]], "y": ys[idx[t]]} for t in range(steps))
        eng = PhaseEngine(ls_loss, opt, sched, device=device, **comm)
        w0 = {"w": torch.zeros(c.num_dims, device=device)}
        # several phases where the schedule has no period, so that the
        # step time leaves out only the first
        block = {"stochastic": 16, "minibatch": 4}.get(sched.kind)
        return eng.run(w0, data, num_workers=mw, seed=0, record_every=1,
                       phase_len=block, return_state=True)

    periodic16 = AveragingSchedule("periodic", phase_len=16)
    hier = AveragingSchedule("hierarchical", inner_groups=4,
                             inner_phase_len=8, outer_phase_len=32)
    int8 = Compression("int8")
    f32 = {}
    for name, sched, steps, comm, expect in (
            ("periodic", AveragingSchedule("periodic", phase_len=128), 256,
             {}, {"avg_disp": 2}),
            ("hierarchical", hier, 64, {}, {"avg_disp": 8}),
            ("ring", periodic16, 64, dict(topology=Topology.ring(mw)),
             {"mix_disp": 4}),
            ("gossip_pairs", periodic16, 64,
             dict(topology=Topology.gossip_pairs(mw)), {"mix_disp": 4}),
            ("stochastic", AveragingSchedule("stochastic", zeta=0.1), 64, {},
             None),
            ("int8", periodic16, 64, dict(compression=int8),
             {"compressed_mix": 4}),
            ("minibatch-torus-int8", AveragingSchedule("minibatch"), 16,
             dict(topology=Topology.torus(mw), compression=int8),
             {"compressed_mix": 16}),
            ("outer", periodic16, 64,
             dict(outer=OuterOptimizer(lr=1.0, momentum=0.5)),
             {"avg_disp_outer": 4})):
        zero_counts()
        final, hist, state = convex_run(sched, steps, "cuda", **comm)
        events = hist["averages"]
        if expect is None:  # stochastic: one avg_disp per drawn event
            expect = {"avg_disp": events}
            check(events > 0, f"{name}: no event drawn")
        got = read_counts(dict(expect, opt_step=steps), name)
        losses = [v for _, v in hist["loss"]]
        check(all(map(math.isfinite, losses)), f"{name}: losses")
        check(events == sum(v for k, v in got.items() if k != "opt_step"),
              f"{name}: {events} events, launches {got}")
        if "compression" in comm:
            check(bool(torch.isfinite(state.resid).all()),
                  f"{name}: residual not finite")
        f0, f1 = objective(torch.zeros(c.num_dims)), objective(final["w"])
        check(f1 < f0, f"{name}: objective {f0} -> {f1}")
        f32[name] = dict(steps=steps, events=events, launches=got,
                         objective_start=f0, objective_end=f1,
                         step_ms=steady_step_ms(hist["phase_wall"]))
        del final, hist, state

    # the same runs on the CPU (the kernels' plain versions) as reference
    final_c, hist_c, _ = convex_run(hier, 64, "cpu")
    final_g, hist_g, _ = convex_run(hier, 64, "cuda")
    check([t for t, _ in hist_c["dispersion"]]
          == [t for t, _ in hist_g["dispersion"]], "event steps cuda vs cpu")
    np.testing.assert_allclose(final_g["w"].cpu().numpy(),
                               final_c["w"].numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose([v for _, v in hist_g["loss"]],
                               [v for _, v in hist_c["loss"]], rtol=1e-4,
                               atol=1e-7)
    # gossip matchings + int8 stochastic rounding: the same draws on both
    # devices, so the same events; the quantizer may round an entry one
    # int8 quantum apart where the two devices' gradients differ in the
    # last bit (card_check.count_quantum_flips)
    gi = dict(topology=Topology.gossip_pairs(mw), compression=int8)
    fc, hc, sc = convex_run(periodic16, 64, "cpu", **gi)
    fg, hg, sg = convex_run(periodic16, 64, "cuda", **gi)
    check([t for t, _ in hc["dispersion"]] == [t for t, _ in hg["dispersion"]]
          and hc["averages"] == hg["averages"] == 4,
          "gossip+int8 event steps cuda vs cpu")
    np.testing.assert_allclose([v for _, v in hg["loss"]],
                               [v for _, v in hc["loss"]], rtol=1e-4,
                               atol=1e-7)
    flips = cc.count_quantum_flips(sg.plane.cpu(), sc.plane, rtol=1e-4,
                                   atol=1e-6)
    # the LM path at a small size: CPU-initialized f32 params, the same
    # batches, on the card and on the CPU
    rcfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                               dtype="float32")
    rparams = init_params(rcfg, 0, device="cpu")
    streams = [token_stream(rcfg.vocab_size, 2, 16, seed=i)
               for i in range(4)]
    rbatches = [{"tokens": np.stack([next(st) for st in streams])}
                for _ in range(4)]

    def lm_run(device):
        eng = PhaseEngine(lambda p, b, r: lm_loss(rcfg, p, b),
                          Momentum(lr=0.01, mu=0.9),
                          AveragingSchedule("periodic", phase_len=2),
                          device=device)
        return eng.run(rparams, iter(rbatches), num_workers=4, seed=0,
                       record_every=1)

    (lm_g, hl_g), (lm_c, hl_c) = lm_run("cuda"), lm_run("cpu")
    check(hl_g["averages"] == hl_c["averages"] == 2, "reduced LM events")
    np.testing.assert_allclose([v for _, v in hl_g["loss"]],
                               [v for _, v in hl_c["loss"]], rtol=1e-4)
    for a_, b_ in zip(torch.utils._pytree.tree_leaves(lm_g),
                      torch.utils._pytree.tree_leaves(lm_c)):
        np.testing.assert_allclose(a_.cpu().numpy(), b_.numpy(), atol=1e-4)
    # the host cost of the key split every step pays (PhaseEngine._step)
    from repro_torch import rng
    key = rng.PRNGKey(0)
    t = time.perf_counter()
    for _ in range(1000):
        key = rng.split(key)[0]
    key_split_us = (time.perf_counter() - t) * 1e3
    emit({"phase": "f32_path", "config": c.name, "samples": c.num_samples,
          "dims": c.num_dims, "workers": mw, **f32,
          "key_split_us_per_step": key_split_us,
          "cuda_vs_cpu": {"ls_hierarchical_64": "rtol 1e-4",
                          "ls_gossip_int8_64": {"losses": "rtol 1e-4",
                                                "quantum_flips": flips},
                          "reduced_lm_periodic_4": "rtol 1e-4 / atol 1e-4"},
          "card": smi})

    # ---- 5. serving at full width (bf16, random weights) ------------------
    from repro_torch.launch import serve, steps
    served = {}
    for arch, run in SERVE.items():
        cfg = get_config(arch)
        batch, plen, gen = run["batch"], run["prompt"], run["gen"]
        params = init_params(cfg, 0, device=dev)
        prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                               generator=torch.Generator().manual_seed(1)
                               ).to(dev)
        # warm-up prefill (cuBLAS set-up, the kernels' first launches)
        serve.prefill(cfg, params, prompt, max_len=gen)
        free()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        logits, cache = serve.prefill(cfg, params, prompt, max_len=gen)
        torch.cuda.synchronize(dev)
        t_pre = time.perf_counter() - t0
        pre = read_counts(run["launches"], f"serve {arch} prefill")
        zero_counts()
        t0 = time.perf_counter()
        toks = serve.decode(cfg, params, logits, cache, max_len=gen)
        torch.cuda.synchronize(dev)
        t_dec = time.perf_counter() - t0
        dec = read_counts({}, f"serve {arch} decode")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        check(tuple(toks.shape) == (batch, gen), f"{arch}: tokens "
              f"{tuple(toks.shape)}")
        check(0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size,
              f"{arch}: a token beyond the vocabulary")
        check(bool(torch.isfinite(logits).all()), f"{arch}: logits")
        del cache
        free()
        # the plain path on the card (einsum attention, the associative
        # scan): launches none of the kernels; reported, not gated, since
        # random-init logits over the vocabulary sit close together
        zero_counts()
        plogits, pcache = serve.prefill(cfg, params, prompt, max_len=gen,
                                        impl="plain")
        ptoks = serve.decode(cfg, params, plogits, pcache, max_len=gen)
        read_counts({}, f"serve {arch} plain")
        step_run = {}
        if "step_launches" in run:
            # the cacheless prefill step, the path of the arch's kernel,
            # after a warm-up; its last logits against the serve
            # prefill's (kernel against the chunked path; reported)
            step = steps.make_prefill_step(cfg)
            step(params, {"tokens": prompt})
            free()
            torch.cuda.reset_peak_memory_stats(dev)
            zero_counts()
            t0 = time.perf_counter()
            last = step(params, {"tokens": prompt})
            torch.cuda.synchronize(dev)
            t_step = time.perf_counter() - t0
            got = read_counts(run["step_launches"], f"{arch} prefill step")
            step_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            check(tuple(last.shape) == (batch, cfg.padded_vocab)
                  and bool(torch.isfinite(last).all()),
                  f"{arch}: prefill step logits")
            step_run = dict(
                prefill_step_ms=t_step * 1e3, launches_prefill_step=got,
                prefill_step_peak_memory_gb=step_peak_gb,
                prefill_step_vs_serve_last_logits_max_abs_diff=float(
                    (last - logits[:, -1]).abs().max()),
                prefill_step_vs_serve_equal_argmax=float(
                    (last.argmax(-1) == logits[:, -1].argmax(-1))
                    .float().mean()))
            del last
            free()
        if run["launches"]:
            # kernel against plain; where the serve prefill launches no
            # kernel (rwkv6-7b) both runs take the same path: left out
            step_run.update(
                kernel_vs_plain_last_logits_max_abs_diff=float(
                    (logits - plogits).abs().max()),
                kernel_vs_plain_equal_tokens=float(
                    (toks == ptoks).float().mean()))
        served[arch] = dict(
            batch=batch, prompt=plen, gen=gen, params=cfg.num_params(),
            prefill_ms=t_pre * 1e3, decode_ms_per_token=t_dec * 1e3 / gen,
            prefill_tokens_per_s=batch * plen / t_pre,
            decode_tokens_per_s=batch * gen / t_dec,
            end_to_end_tokens_per_s=batch * gen / (t_pre + t_dec),
            launches_prefill=pre, launches_decode=dec,
            peak_memory_gb=peak_gb, tokens_first_row=toks[0, :12].tolist(), **step_run)
        del params, prompt, logits, plogits, pcache, toks, ptoks
        free()
    # the CLI on the card, once
    zero_counts()
    cli_toks = serve.main(["--arch", "smollm-360m", "--batch", "2",
                           "--prompt-len", "64", "--gen", "4"])
    read_counts({"flash_attention": 32}, "serve CLI")
    check(tuple(cli_toks.shape) == (2, 4), "serve CLI tokens")
    emit({"phase": "serve", **served, "card": smi})

    # ---- 6. summary --------------------------------------------------------
    def line(name, src, replaces, row):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}.cu",
                "replaces": replaces, "launches": main_launches[name],
                "max_abs_err": err[name], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms")}

    emit({"kernels": [
        line("opt_step", "opt_step", "src/repro/kernels/opt_step.py:185",
             full["opt_step/none"]),
        line("avg_disp", "avg_disp", "src/repro/kernels/avg_disp.py:156",
             full["avg_disp/g1"]),
        line("mix_disp", "mix_disp", "src/repro/kernels/avg_disp.py:203",
             full["mix_disp/ring"]),
        line("avg_disp_outer", "avg_disp_outer",
             "src/repro/kernels/avg_disp.py:251",
             full["avg_disp_outer/nesterov"]),
        line("compressed_mix", "compressed_mix",
             "src/repro/kernels/avg_disp.py:295",
             full["compressed_mix/one_bit-mix-codes"]),
        line("flash_attention", "flash_attention",
             "src/repro/kernels/flash_attention.py:75",
             full["flash_attention/recurrentgemma-2b"]),
        line("rglru_scan", "rglru_scan", "src/repro/kernels/rglru_scan.py:46",
             full["rglru_scan/recurrentgemma-2b"]),
        line("rwkv6_scan", "rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:47",
             full["rwkv6_scan/rwkv6-7b"])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind_name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
