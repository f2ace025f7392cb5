#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each printing one JSON line:
  0. the port's static pass (``phase_static``; its budget, 10 s, printed
     first), before any build: ``python -m repro_torch.analysis --format
     json`` in a subprocess from the script's root must exit 0 with
     ``"ok": true``; the rule counts, the baseline's entries by rule and
     the kernels ``kernel-twin`` discovers, which the summary holds
     against the kernels the card ran;
  1. card + build: the device, ``nvidia-smi`` name and power limit, and
     the build of every CUDA kernel under src/repro_torch/kernels/csrc/;
     the bf16 flash kernel's (``flash_fwd_wgmma``) registers and spills
     per head dim, none allowed at 64, 128 and 256, and its ``HGMMA``
     (tensor-core) instructions counted in the SASS by ``cuobjdump``
     where the toolkit or Triton has one, each head dim needing some; the
     same for ``rwkv6_scan``'s ``rwkv6_chunk_mma`` per head dim and input
     type (no spills at 64, TF32 ``HMMA`` in each instantiation); the
     registers and spills of each of ``avg_disp_cols``' 40
     instantiations, none spilling up to 32 workers;
  2. kernels vs plain: ``opt_step`` (modes none / mean / group / mix and
     the wire path), ``avg_disp``, ``mix_disp``, ``avg_disp_outer`` and
     ``compressed_mix`` against their plain PyTorch versions over the
     sweep of ``repro_torch.kernels.card_check`` (``avg_disp`` and
     ``mix_disp`` also with bf16 and mixed rounding codes, bitwise) and
     at full width (M=4 workers x P=361,821,120, smollm-360m; the coded
     ``avg_disp`` mean, ``mix_disp`` ring mix and ``avg_disp_outer``
     outer step of the LM plane too),
     bitwise reproducible across two runs, timed with CUDA events beside
     their memory bound (``avg_disp``'s one launch an event
     (``card_check.avg_sweep``; each timed plane held by
     ``check_avg_event``: one launch a call, the finisher's ticket back
     at 0), its full-width rows, the CNN's plane and the least squares'
     24 x 1024 plane split by ``call_split``: device µs, the host path,
     and at the CNN's plane one trace's kernels a call (one, no
     ``sum_partials``)); then
     ``flash_attention``, ``rglru_scan`` and ``rwkv6_scan`` over
     card_check's serving sweep (the JAX suite's shapes in float32 and
     bfloat16, and the serving shapes) and timed at the serving shapes
     beside their bounds, their plain versions and, for flash attention,
     ``scaled_dot_product_attention`` (the backend that ran is named),
     with both achieved TFLOP/s, both device-busy times under
     ``torch.profiler`` (``device_ms``: CUDA events around back-to-back
     calls also hold the host's launch path where it is the longer) and
     the kernel's share of its bound;
     ``rwkv6_scan`` is held to the recurrence evaluated in float64, its
     error reported beside the float32 plain version's own;
  3. the main path at full width: ``repro_torch.launch.train`` trains
     smollm-360m (bf16, 4 workers, Momentum) — periodic K=2 (the coded
     mean in ``avg_disp``; 4 steps, 6 until phase 14 needed the time),
     periodic K=2 over a ring (the coded mix in
     ``mix_disp``), minibatch, minibatch over a ring (``opt_step`` mode
     mix), periodic K=2 over a ring with the one_bit wire
     (``compressed_mix``), minibatch with the bf16 wire (the
     ``opt_step`` wire path), and periodic K=2 with the outer optimizer
     (``--outer-momentum 0.5``: the coded outer step in
     ``avg_disp_outer``, its plain version never called);
  4. the f32 path: the paper's least-squares ``synth-ls-sparse-highrho``
     (4096 x 1024, 24 workers, SGD on lr0 / (t - 1 + d)), its batches
     gathered on the card from a ``DeviceDataset`` index list, its loss
     and objective ``models.convex``'s, under periodic, hierarchical,
     ring and gossip-pairs (``mix_disp``), stochastic, int8
     (``compressed_mix``), minibatch over a torus with int8 (``opt_step``
     mix + wire) and the outer optimizer (``avg_disp_outer``); the
     hierarchical run again from a generator of the same batches, bitwise
     its indexed twin; then small runs on the card and on the CPU (the
     kernels' plain versions), which must agree;
  5. the paper's §3.1 convex suite at the ``CONVEX_SUITE`` sizes (two
     least squares, two logistic regressions, 24 workers;
     ``phase_convex_curves``): w* from ``solve_optimum`` and its
     checks, σ², β² and ρ from ``experiments.table1.table1_row``, then
     Figure 2's paired-draw curves through
     ``experiments.fig2_convex.sgd_curves`` (its engine wrapped here to
     count each curve's launches) — oneshot, minibatch, periodic 64,
     periodic 128 and one worker, 128 steps each, the objective every 64
     steps — with their events, launches (``opt_step`` 128; ``avg_disp``
     2 / 1 / 0 / 0), steady ms per step and normalized suboptimality;
     and one config run three ways over 256 steps (indexed, staged from
     host batches, ``run_host``), bitwise equal, with their ms per step;
  6. serving at full width (``repro_torch.launch.serve``, bf16, random
     weights): recurrentgemma-2b, batch 4, a prompt of 3072 (beyond its
     2048 window), 32 tokens generated — the prefill launches
     ``flash_attention`` 8 times and ``rglru_scan`` 18 times, decode
     neither; smollm-360m, batch 4, a prompt of 2048, 32 generated — 32
     ``flash_attention`` launches; rwkv6-7b, batch 4, a prompt of 2048,
     32 generated — its cache-capturing prefill takes the chunked WKV and
     launches no kernel, as the reference's does, and its cacheless
     prefill step (``steps.make_prefill_step``) launches ``rwkv6_scan``
     32 times, timed and held against the serve prefill's last logits
     (reported, not gated); ``init_params`` seconds (the reference's
     keys, drawn on the card), prefill ms, decode ms per token, tokens/s
     and peak memory; the kernel path against ``impl="plain"`` on the card
     where the serve prefill launches a kernel (reported, not gated);
     and the serve CLI once (``serve_run``, which phases 12-13 run too);
  7. faults (``repro_torch.faults``, the plane passes' ``alive`` /
     ``umask`` paths, each one launch of its kernel's masked pass):
     card_check's fault sweep (dead, straggling and all-alive rows, and
     a group with no alive row, over the JAX suite's shapes, with and
     without codes); at full width (M=4 x P=361,821,120, one dead row)
     the fault paths of ``opt_step`` (Momentum, bf16 codes; mode none
     and the masked mean), ``avg_disp`` and ``mix_disp`` (f32 and bf16
     codes each, timed on clones: they run in place) and
     ``compressed_mix`` (one_bit over a ring) against their masked plain
     versions, timed beside their bounds (the masked kernels' one-pass
     bound, with the wrapped yardstick of PR 20 beside it, and for the
     masked mix ``torch.matmul`` over the degraded W); smollm-360m
     training at full
     width under ``--faults crash:m=1@t=3,rejoin:m=1@t=6
     --straggle-prob 0.25 --rejoin-curriculum 2`` (periodic K=2,
     minibatch, ring + one_bit; 8 steps each, the last one under
     ``torch.profiler``) beside the same runs without the plan: step
     ms, device-busy ms, peak memory, and their differences; the
     least squares of phase 4 (160 steps from a ``DeviceDataset``,
     crash:m=3@t=40,crash:m=7@t=40,rejoin:m=3@t=120, straggle 0.1,
     curriculum 16) under periodic 16, hierarchical (2 groups), ring,
     int8, minibatch over a torus with int8, and adaptive_threshold with
     and without ``straggle_aware``, each against the same run on the
     CPU (the same event steps, alive and staleness rows; params within
     rtol 1e-4, the int8 runs' objective within rtol 1e-3, their spread
     reported beside the same int8 run without the plan), and
     ``run_host`` bitwise ``run`` on the card; one paired curve, periodic
     128 with and without the plan, the objective every 64 steps;
  8. elastic membership and checkpoints (``repro_torch.elastic``,
     ``repro_torch.checkpoint``): smollm-360m at full width under the
     CLI's ``--shrink-at 3:2 --grow-at 5:4 --rejoin-curriculum 1``
     (periodic K=2, 8 steps, in five ``run_elastic`` calls: the resize
     lines, step ms and peak memory of each call), a trivial plan
     bitwise the plain run; the same run through the CLI checkpointed at
     step 4 (``--checkpoint``, v5, M=2) into a temporary directory and
     resumed (``--resume``), bitwise the run of (a), with the bytes
     written and the seconds to save and load, the files deleted after;
     the least squares of phase 4 (24 workers) shrunk to 16 before step
     64 and grown back before 160 (curriculum 16) under a fault plan, on
     the card against the CPU port;
  9. telemetry (``repro_torch.telemetry``): smollm-360m at full width
     (periodic K=2, 4 steps) through the CLI three times, plain, with
     ``--telemetry`` and with ``--telemetry --profile-dir`` into a
     temporary directory (deleted after): the consensus bitwise the
     plain run's, the JSONL read back by ``RunLog`` into the returned
     history, one ``averaging_event`` per event, each phase's
     ``comm_bytes`` its events' priced bytes folded in float32, the
     report rendered, the trace holding ``opt_step_cols`` and
     ``avg_disp_cols`` device events, each run's step ms; the least
     squares of phase 8 (c) through ``run_elastic(sink=MemorySink())``
     on the card and on the CPU: the same records, integer fields exact,
     floats within rtol 1e-4, the occupancy the segment plans' streams;
 10. the paper's §3.2 CNN (Fig. 3) at ``CNNConfig``'s widths (LeNet5,
     32/64 channels, fc 512; P = 1,663,370, 4 workers, batch 8,
     Momentum 0.9, lr 0.01 x0.95 an epoch) on ``mnist_like`` (4096
     train, 512 test, noise 0.6) through ``experiments.fig3_cnn.run_cnn``
     (its engine wrapped here to count each schedule's launches and keep
     its state): periodic-10 and oneshot from one ``DeviceDataset`` in
     permute mode, 256 steps each, evaluated every 25 (``opt_step``
     launches = steps, ``avg_disp`` = events, no plain version called on
     the card); a profile of 20 steps (device busy,
     idle share); the first 50 steps on the card against the CPU, each
     from the CPU's state (``CNN_LOSS_RTOL``, ``CNN_PLANE_TOL``,
     ``CNN_FLIP_FRAC``), a free-running card run beside them reported;
     ``opt_step`` and ``avg_disp`` held against their plain versions
     and timed at the CNN's plane beside their bounds (``avg_disp``
     split by ``call_split``: its device µs and host path beside the
     CUDA-event ms); one batch's
     gradients against float64 (``conv_gradients``: the port's im2col
     convolution gated, ``F.conv2d`` with and without cuDNN reported);
     the final train loss and test error per schedule and the paper's
     two Fig. 3 statements (printed, not gated); then Lemma 1 through
     ``experiments.lemma1.lemma1_rows`` on the card over bench_lemma1's
     zetas and 3000 steps (2000 reps) against the closed form and
     against the CPU's run of the same draws (64 reps); and (b)
     (``phase_paper_nonconvex``; its budget, 15 s, printed first) Figure
     1 (``experiments.fig1_pca``, bench_fig1_pca.run's 24 workers x 4000
     samples, six phase lengths) and the §2.4 quartic
     (``experiments.quartic``, ``QuarticConfig``: 24 workers, 10,000
     steps, four averaging fractions) on the card, each against the
     port's CPU run of the same draws (``FIG1_RTOL``, ``QUARTIC_RTOL``),
     their wall seconds and the kernels a run (``torch.profiler``);
 11. the sharded plane (``PhaseEngine(mesh=, collective=)``,
     ``repro_torch.launch.mesh``; ``phase_sharded``): (a) the least
     squares of phase 4 (64 steps; periodic-8, stochastic, and a ring
     with the int8 wire under a fault plan) on 4 gloo ranks that share
     the card, started with ``torch.multiprocessing`` over a ``file://``
     rendezvous, 6 worker rows each, under ``gather`` (bitwise the
     unsharded card run; each rank launches what the unsharded step
     launches) and ``psum`` (one ``opt_step`` launch a step on the
     rank's rows; the same decisions, params within rtol 1e-5 / atol
     1e-7); (b) smollm-360m at full width (phase 3's periodic run) on 2
     gloo ranks under ``psum``: the same events and losses as phase 3's
     run, the consensus bitwise; per rank the peak memory, step ms, the
     collectives' ms (the 1.45 GB column-sum all-reduce) and the local
     column-sum, squared-distance and broadcast passes and a row's bf16
     encode (plain torch, as the reference's are jnp); (c) the CLI's
     ``--shard --collective gather`` under ``torchrun --nproc-per-node
     1`` (NCCL) on ``--reduced`` smollm-360m: bitwise the unsharded
     CLI's checkpoint;
 12. the decoder-only zoo (``phase_zoo``): served at full width through
     ``serve_run`` as phase 6 serves (bf16, random weights): starcoder2-3b
     (batch 4, a prompt of 5120 past its 4096 window; 30
     ``flash_attention`` launches a prefill), minitron-8b (4 x 2048; 32),
     gemma3-27b (2 x 2048 past its 1024 window, 52 local and 10 global
     layers; 62), phi3.5-moe-42b-a6.6b at 4 of its 32 layers (4 x 2048,
     16 experts top-2 at the published widths; 4) and
     llama4-maverick-400b-a17b at 2 of 48 (1 x 2048, 128 experts top-1
     and the shared expert; 2), 32 / 32 / 32 / 16 / 8 tokens generated,
     decode launching nothing; the serve CLI once for starcoder2-3b
     (``--batch 1 --gen 4``); then phi3.5-moe at its published widths cut
     to one layer (P = 1.56e9) trained through ``launch/train.py``'s
     ``setup``
     (bf16, 2 workers, Momentum, periodic K=2, 4 steps; ``opt_step`` once
     a step, ``avg_disp`` once an event), twice, bitwise equal;
 13. encoders and cross-attention (``phase_encdec``): served through
     ``serve_run`` with the frames in the batch (``serve.frames``, as the
     serve CLI draws them; bf16, random weights): whisper-small at its
     published depth (12 encoder + 12 decoder layers, d 768), batch 16,
     1500 frames, a prompt of 384 and 64 tokens generated (its 448 text
     positions) — 24 ``flash_attention`` launches a prefill, 12 of them
     unmasked (the encoder), cross-attention on the einsum path, decode
     launching nothing; llama-3.2-vision-90b at its published widths cut
     to 10 of its 100 layers (two periods of 4 self : 1 cross-only;
     P = 1.07e10), batch 2, 1601 media tokens, a prompt of 2048, 16
     tokens — 8 launches a prefill; the serve CLI once for whisper-small
     (``--batch 2 --gen 4``); the phase's ``wall_s``;
 14. the tree and unfused carries, the training steps and the banded
     branch (``phase_tree``; its budget, 45 s on a normal host, printed
     first): (a) the CLI's ``--tree-engine`` and ``--no-fused-opt``
     (periodic K=2, 4 steps) and ``--tree-engine`` over a ring with the
     one_bit wire, each against phase 3's flat-native run of the same
     argv: decisions, events and losses, the final params within one
     bf16 ulp (``CARRY_TOL``, the worst element reported), the returned
     state in the plane layout, the launches (``opt_step`` none in
     either carry, ``avg_disp`` an event under ``--no-fused-opt``,
     ``compressed_mix`` an event in the one_bit tree run, no plane kernel
     in the plain tree run), step ms and peak memory; (b)
     ``steps.make_phase_step`` at full width (2 steps and the average,
     flat-native: ``opt_step`` x 2, ``avg_disp`` x 1) with remat off and
     on, bitwise equal, against two ``make_train_step`` steps and
     ``average_all`` (within ``CARRY_TOL``), and its peak memory with
     and without remat at B 4 x REMAT_SEQ (and the allocator's growth
     while that call's arguments are built); (c) recurrentgemma-2b whole
     (bf16), its cacheless plain prefill banded against masked at
     BANDED_SHAPES: the last logits within BANDED_LOGIT_ATOL, ms, peaks
     and the score count a head of each;
 15. the dry run, the roofline and the examples (``phase_dryrun``; its
     budget, 40 s on a normal host, printed first): (a)
     ``examples/quickstart_torch.py`` on the card and then with
     ``--device cpu`` at QUICKSTART_STEPS a schedule: the same averages,
     ``opt_step`` a step and ``avg_disp`` a periodic event, the eval
     losses within QUICKSTART_EVAL_RTOL; (b) phase 14 (b)'s long phase
     step counted on ``meta`` by ``repro_torch.roofline.count_step``:
     flops, bytes, 6ND, the lower bound against the time phase 14
     measured (``bound_share`` at most BOUND_SHARE_MAX) and ``mfu``, the
     counted argument bytes within ARG_BYTES_RTOL of the allocator's
     growth; (c) ``python -m repro_torch.launch.dryrun`` for one row
     (smollm-360m, train_4k, one pod) in a subprocess over torch's fake
     process group: exit 0 and the row's keys;
 16. summary: a ``kernels`` line over all eight kernels (``opt_step``,
     ``avg_disp``, ``mix_disp`` and ``compressed_mix`` also with their
     masked pass's ``fault_ms`` and ``fault_bound_ms``), whose names must
     be the set phase 0 discovered, each launched on the main path and
     held against its plain version in this call; the card, then
     ``{"ok": true, "device": ...}`` as the last line.

Every launch count is set to 0 just before a main-path run (phases 3-15;
a spawned rank zeroes and reads its own) and read just after; the
``kernels`` line sums those runs. Any failed
check raises, so the script exits non-zero without the ``ok`` line; it
also refuses to run without a CUDA device. All of its work happens under
``if __name__ == "__main__"``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM, bf16 tensor cores, dense
FULL_M, FULL_P = 4, 361_821_120
NSTATE = {"sgd": 0, "momentum": 1, "adamw": 2}
# the serving runs of phase 6: batch, prompt length, tokens generated,
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
# the convex suite of phase 5 (the paper's §3.1 protocol): steps per curve
# (1024 until phase 7 needed the time, 512 until phase 12 did, 256 until
# phase 13 did: the script must end within its limit on the slower hosts,
# where the host-bound phases run 1.3-1.5x longer), its periodic curves
# at periods of half and all of them, eval every SUITE_EVERY steps, SGD
# at lr0 / (t - 1 + d) with lr0 = mult * d / mean ||x_j||², and the steps
# of the indexed / staged / run_host comparison
SUITE_STEPS, SUITE_EVERY = 128, 64
SUITE_LR_MULT, SUITE_LR_D = 0.8, 200.0
HOST_STEPS = 256
# phase 7's least squares under a fault plan: steps a run (256 until
# phase 12 needed the time; the plan's last rejoin and its curriculum end
# at step 136), and of its paired periodic-128 curve
FAULT_LS_STEPS, FAULT_CURVE_STEPS = 160, 256


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound_ms(nbytes: float, flops: float,
             peak: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def host_launch_us(dev, n: int = 20000) -> float:
    """µs per launch of a tiny elementwise op on ``dev`` (host-bound):
    the cost every eager launch pays in this process. A torch.profiler
    session raises it for the rest of the process, so the phases after
    one read slower host-bound steps."""
    import torch
    x = torch.zeros(16, device=dev)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    for _ in range(n):
        x = x + 1.0
    torch.cuda.synchronize(dev)
    return 1e6 * (time.perf_counter() - t) / n


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


def avg_disp_cost(m, p, has_codes=False):
    """(bytes, flops): the plane (and the codes row) read once, the
    output written once; a sum, a difference, a square and an add per
    element."""
    return 2 * m * p * 4 + (p * 4 if has_codes else 0), 4 * m * p


def mix_disp_cost(m, p, has_codes=False):
    """The plane, W (and the codes row) read once, the mixed plane
    written once; 2M flops of the mix and 4 of the dispersion per
    element."""
    return (2 * m * p * 4 + m * m * 4 + (p * 4 if has_codes else 0),
            (2 * m + 4) * m * p)


def masked_event_cost(m, p, n_alive, has_codes, mix=False):
    """The least a masked ``avg_disp`` / ``mix_disp`` pass moves: the
    ``n_alive`` rows read and written once, the codes row read (a mix:
    W too); a dead row nothing. Flops as :func:`avg_disp_cost` /
    :func:`mix_disp_cost`, on the alive rows (a mix over them)."""
    nbytes = 2 * n_alive * p * 4 + (p * 4 if has_codes else 0) \
        + (m * m * 4 if mix else 0)
    return nbytes, (4 + (2 * n_alive if mix else 0)) * n_alive * p


def avg_disp_outer_cost(m, p, has_codes=False):
    """The plane, prev, vel (and the codes row) read once; the plane, new
    and vel' written once; 4 flops per element and 7 per column for the
    momentum step."""
    return (2 * m * p * 4 + 4 * p * 4 + (p * 4 if has_codes else 0),
            4 * m * p + 7 * p)


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


def fault_extra_cost(p, frozen_rows, n_alive):
    """(bytes, flops) a wrapped fault path (PR 20's yardstick, beside the
    masked kernels' bounds) adds to the kernel it wraps: each of its
    ``frozen_rows`` copied out and written back (4 transfers of a row),
    and the masked dispersion's two reads of the alive rows (the mean,
    then the squared deviations), 3 flops an element."""
    return 4 * frozen_rows * p * 4 + 2 * n_alive * p * 4, 3 * n_alive * p


def masked_opt_step_cost(m, p, kind, has_codes, n_update, n_stale,
                         event=False, mix=False):
    """The least a masked ``opt_step`` pass moves (one pass): each of the
    ``n_update`` stepped rows' x, g and S state rows read and x and the
    state rows written; each of the ``n_stale`` alive rows outside the
    update read (and written, under an ``event``); the codes row read;
    nothing of a row in neither mask (mode mix: W too). Flops: the
    update on the stepped rows, 4 for the masked column sum and
    dispersion term (+ 2 per alive row for a mix) on the alive rows."""
    s = NSTATE[kind]
    n_alive = n_update + n_stale
    nbytes = (n_update * (3 + 2 * s) + n_stale * (2 if event else 1)) \
        * p * 4 + (p * 4 if has_codes else 0) + (m * m * 4 if mix else 0)
    upd = {"sgd": 2, "momentum": 4, "adamw": 14}[kind]
    per = 4 + (2 * n_alive if mix else 0)
    return nbytes, upd * n_update * p + per * n_alive * p


def masked_compressed_cost(m, p, wire, has_codes, n_alive, mix=False):
    """The least a masked compressed event moves: the ``n_alive`` rows'
    plane and residual read and written once, their uniforms read
    (int8), the codes row read (mode mix: W too); a dead row nothing.
    Flops as :func:`compressed_cost`, on the alive rows (a mix over
    them)."""
    planes = 4 + (1 if wire == "int8" else 0)
    nbytes = planes * n_alive * p * 4 + (p * 4 if has_codes else 0) \
        + (m * m * 4 if mix else 0)
    per = {"bf16": 2, "int8": 6, "one_bit": 3}[wire] + 1 \
        + (2 * n_alive if mix else 1) + 4
    return nbytes, per * n_alive * p


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


def avg_disp_kernels(names) -> dict:
    """{"<MAXM>-<V>-<masked>-<codes>": mangled name} of avg_disp.cu's
    sweeps (``avg_disp_cols<MAXM, V, MASKED, CODES>``) among ``names``."""
    import re
    out = {}
    for n in names:
        m = re.search(r"avg_disp_colsILi(\d+)ELi(\d+)ELb([01])ELb([01])E",
                      n)
        if m:
            out["-".join(m.groups())] = n
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


def device_ms(fn, iters) -> float:
    """Device-busy ms per call of ``fn`` under ``torch.profiler`` (the
    union of its kernels' spans), after a warm-up: the kernels' own time,
    where CUDA events around back-to-back calls also hold whatever host
    time a call takes beyond its kernels'."""
    import torch

    from repro_torch.launch.profile import _breakdown, _profiler
    fn()
    torch.cuda.synchronize()
    with _profiler() as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return _breakdown(prof, iters, 1.0)["device_busy_ms"]


def cuda_time(fn, iters) -> float:
    """ms per call of ``fn`` with CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def call_split(fn, iters, prof_iters, trace=False) -> dict:
    """One call of ``fn`` on the card split: ``ms``, :func:`cuda_time`
    over ``iters`` back-to-back calls (a call's host path sits inside it
    wherever that path outlasts its kernels); ``host_us``, the host clock
    over ``iters`` calls with no synchronization between them (the Python
    path to the launches); ``device_us``, CUDA events around
    ``prof_iters`` calls queued behind a spin kernel (``torch.cuda._sleep``)
    that holds the stream until every call is enqueued, so that the card
    runs them back to back with no host time between; and with ``trace``,
    ``torch.profiler`` over ``prof_iters`` calls read by ``_breakdown``:
    ``kernels_per_call``, ``busy_us`` (the union of their spans) and the
    top kernels' ms a call by name."""
    import torch
    out = {"ms": cuda_time(fn, iters)}
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    out["host_us"] = 1e6 * (time.perf_counter() - t) / iters
    torch.cuda.synchronize()
    # about 2e3 cycles a µs (1.98 GHz at most): hold the stream 2x the
    # enqueue plus 10 ms, and check that it still held after it; a host
    # stall longer than that (the host's cores are shared) voids the
    # reading, which is taken again behind a spin twice as long
    spin_us = 2 * prof_iters * out["host_us"] + 1e4
    for _ in range(3):
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        torch.cuda._sleep(int(2e3 * spin_us))
        b.record()
        for _ in range(prof_iters):
            fn()
        c.record()
        held = not b.query()
        torch.cuda.synchronize()
        if held:
            break
        spin_us *= 2
    check(held, f"the spin kernel ({a.elapsed_time(b):.3f} ms) ended "
          f"before {prof_iters} calls were enqueued, three times")
    out["device_us"] = 1e3 * b.elapsed_time(c) / prof_iters
    if not trace:
        return out
    from repro_torch.launch.profile import _breakdown, _profiler
    with _profiler() as prof:
        for _ in range(prof_iters):
            fn()
        torch.cuda.synchronize()
    got = _breakdown(prof, prof_iters, out["device_us"])
    # the launches themselves are held without the profiler (launch
    # counts, the finisher's ticket); a session with no device record at
    # all is the profiler's failure to record, not a kernel's
    check(got["kernels_per_step"] > 0,
          f"torch.profiler recorded no device activity over {prof_iters} "
          "calls (no CUPTI kernel record reached the trace)")
    return dict(out, kernels_per_call=got["kernels_per_step"],
                busy_us=1e3 * got["device_busy_ms"],
                kernel_ms=dict(got["top_kernels"]))


#: avg_disp_cols<MAXM, V, MASKED, CODES>: V in {4, 2, 1} at MAXM 4 and 8,
#: {2, 1} at 16, 1 at 32 and 64 (csrc/avg_disp.cu's kMaxCols), x 2 x 2
AVG_DISP_INSTANTIATIONS = (3 + 3 + 2 + 1 + 1) * 4
#: avg_disp's small planes: the §3.2 CNN's (traced: one kernel a call, no
#: sum_partials) and the paper's least squares, groups 1 and the
#: hierarchical event's 4: (M, P, groups, trace)
AVG_SPLIT_PLANES = {
    "cnn-g1": (4, 1663370, 1, True),
    "ls-g1": (24, 1024, 1, False),
    "ls-g4": (24, 1024, 4, False),
}


def sdpa_time(q, k, v, cuda_time, *, causal, window):
    """The library's yardstick for flash attention, timed but never used
    by the port: ``scaled_dot_product_attention`` on the same inputs (the
    key / value heads repeated to the query heads, the window as a
    boolean band mask), under the first backend that takes them. Returns
    (ms, backend name, max |SDPA - flash_attention|, device-busy ms
    (:func:`device_ms`))."""
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
            dev_ms = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **kw), 5)
        ours = flash_attention(q, k, v, causal=causal, window=window)
        diff = float((out.transpose(1, 2).float() - ours.float()).abs().max())
        return ms, backend.name, diff, dev_ms
    raise RuntimeError("no scaled_dot_product_attention backend took the "
                       "inputs")


# ---- phases 9 and 10 ------------------------------------------------------
# the paper's §3.2 CNN run of phase 10 (bench_fig3_cnn's recipe): steps per
# schedule, eval every CNN_EVERY steps, the images of bench_fig3_cnn.py:28-29,
# and the steps held card against CPU
CNN_STEPS, CNN_EVERY, CNN_TRAIN, CNN_TEST, CNN_NOISE = 256, 25, 4096, 512, 0.6
CNN_PARITY_STEPS = 50
#: card against CPU, each of the CNN's first steps from a common state
#: (TF32 off): the loss within rtol CNN_LOSS_RTOL; of the params and
#: velocity planes after the step, at most CNN_FLIP_FRAC of the elements
#: beyond CNN_PLANE_TOL of the plane's largest magnitude. Float32 sums in
#: other orders (the unfolded convolutions' products, sums of up to 3,136
#: terms) part by ~4e-7 of a gradient's scale; a ReLU or max-pool decision
#: an ulp from its edge, flipped, moves the few hundred to some ten
#: thousand gradient elements behind that unit by far more (an H100 run saw
#: 4.1e-4 of the params' scale at step 38), and cuDNN's convolution
#: gradients, which part by some 1e-3 (``conv_gradients``), move every
#: convolution weight's: 3% of a row
CNN_LOSS_RTOL, CNN_PLANE_TOL, CNN_FLIP_FRAC = 1e-5, 1e-5, 1e-2
#: phase 10's Lemma 1 runs (``experiments.lemma1``: bench_lemma1.py's
#: zetas and steps): the reps of the card runs, and of the CPU twins they
#: are held against (rtol 1e-4: the same threefry draws, normals an ulp
#: apart where the card's log1p is)
LEMMA1_REPS, LEMMA1_CPU_REPS = 2000, 64
#: the zetas of the reference's own Lemma 1 test, gated at its rel 0.15
LEMMA1_GATED = (0.0, 0.02, 0.1, 1.0)


def _close(a, b, rtol, atol=0.0) -> bool:
    return abs(a - b) <= atol + rtol * abs(b)


def phase_telemetry(cx) -> dict:
    """Phase 9: (a) smollm-360m through the CLI, plain, with
    ``--telemetry``, and with ``--telemetry --profile-dir`` (bitwise
    consensus, the log against the history, the events' priced bytes,
    the report, the trace's device events); (b) the least squares of
    phase 8 (c) through ``run_elastic(sink=MemorySink())``, card against
    CPU."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch import elastic, rng
    from repro_torch.configs.paper import CONVEX_SUITE
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.data import DeviceDataset, convex_dataset
    from repro_torch.faults import FaultPlan
    from repro_torch.launch import train
    from repro_torch.models.convex import make_problem
    from repro_torch.optim import SGD
    from repro_torch.telemetry import MemorySink, RunLog
    from repro_torch.telemetry.report import render
    from repro_torch.topology import Topology, comm_bytes

    t_ph = time.perf_counter()
    argv = cx.common + ["--avg", "periodic", "--phase-len", "2", "--steps",
                        str(cx.tele_steps)]
    events = cx.tele_steps // 2
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tele_")
    runs, cli = {}, {}
    try:
        logs = {n: os.path.join(tmp, f"{n}.jsonl")
                for n in ("telemetry", "profiled")}
        prof = os.path.join(tmp, "prof")
        for name, extra in (
                ("plain", []),
                ("telemetry", ["--telemetry", logs["telemetry"]]),
                ("profiled", ["--telemetry", logs["profiled"],
                              "--profile-dir", prof])):
            cx.zero_counts()
            t = time.perf_counter()
            final, hist, state = train.main(argv + extra)
            cx.sync()
            wall = time.perf_counter() - t
            got = cx.read_counts({"opt_step": cx.tele_steps,
                                  "avg_disp": events}, f"telemetry {name}")
            width = state.plane.shape[1]
            runs[name] = (final, hist)
            cli[name] = dict(wall_s=wall, launches=got,
                             step_ms=steady_step_ms(hist["phase_wall"]),
                             averages=hist["averages"])
            del state
            cx.free()
        base = runs["plain"][0]
        for name in ("telemetry", "profiled"):
            final, hist = runs[name]
            check(all(torch.equal(a, b) for a, b in zip(
                _leaves(final), _leaves(base))),
                f"telemetry {name}: consensus not bitwise the plain run's")
            log = RunLog.load(logs[name])
            check(log.history() == hist,
                  f"telemetry {name}: RunLog.history() != the history")
            evs = log.of_type("averaging_event")
            check(len(evs) == hist["averages"] == events,
                  f"telemetry {name}: {len(evs)} averaging events, "
                  f"{hist['averages']} averages")
            eb = np.float32(comm_bytes(Topology.full(cx.workers), 1, width,
                                       "f32"))
            for ph in log.phases:
                want = np.float32(0.0)
                for _ in range(ph["events"]):
                    want = np.float32(want + eb)
                check(ph["comm_bytes"] == float(want),
                      f"telemetry {name}: phase {ph['t0']}-{ph['t1']} "
                      f"comm_bytes {ph['comm_bytes']}, want {want}")
            check(sum(ph["events"] for ph in log.phases) == events,
                  f"telemetry {name}: events in phase_metrics")
            meta = log.meta
            check(meta["backend"] == cx.dev.type
                  and meta["config"]["workers"] == cx.workers,
                  f"telemetry {name}: run_meta {meta}")
            text = render(log)
            check(f"total: {cx.tele_steps} steps, {events} events" in text,
                  f"telemetry {name}: report\n{text}")
            cli[name].update(records=len(log.records),
                             comm_bytes=sum(ph["comm_bytes"]
                                            for ph in log.phases),
                             bytes_per_event=float(eb))
        print(text, flush=True)
        # the trace: the update and the event kernels ran on the card
        traces = [f for f in os.listdir(prof) if f.endswith(".json")]
        check(len(traces) == 1, f"profile dir holds {traces}")
        path = os.path.join(prof, traces[0])
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in trace
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        kern = {k: sum(k in n for n in names)
                for k in ("opt_step_cols", "avg_disp_cols")}
        if cx.dev.type == "cuda":
            check(all(v > 0 for v in kern.values()),
                  f"trace device events {kern} of {len(names)}")
        cli["profiled"].update(trace_bytes=os.path.getsize(path),
                               trace_device_events=len(names),
                               trace_kernels=kern)
    finally:
        shutil.rmtree(tmp)
    check(not os.path.exists(tmp), "telemetry files left behind")
    del runs, base
    cx.free()

    # (b) phase 8 (c)'s least squares, through run_elastic with a sink, on
    # the card and on the CPU
    c = CONVEX_SUITE[0]
    mw = c.num_workers
    X, y, _ = convex_dataset(c.model, c.num_samples, c.num_dims,
                             sparsity=c.sparsity, noise=c.noise, seed=0)
    lr0 = 0.8 * 200.0 / float(np.mean(np.sum(X * X, axis=1)))
    sgd = SGD(lr=lambda t: lr0 / (t - 1.0 + 200.0))
    obj = make_problem("ls")[0]

    def loss(p, b, r):
        w = p["w"]
        return obj(w, b["x"].reshape(-1, w.shape[0]), b["y"].reshape(-1)), {}

    eplan = elastic.ElasticPlan(mw, ((64, 16), (160, mw)), curriculum=16)
    base_plan = FaultPlan.parse("crash:m=3@t=40,rejoin:m=3@t=120", mw,
                                straggle_prob=0.1, rejoin_curriculum=16)
    idx = np.random.default_rng(3).integers(0, c.num_samples, (256, mw))

    def ls_run(device):
        Xs, ys = torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)
        eng = PhaseEngine(loss, sgd, AveragingSchedule("periodic",
                                                       phase_len=16),
                          device=device, faults=base_plan, telemetry=True)

        def data(m, t0, k):
            return DeviceDataset({"x": Xs, "y": ys}, m,
                                 indices=idx[t0 - 1:t0 - 1 + k, :m],
                                 device=device)
        sink = MemorySink()
        out = elastic.run_elastic(
            eng, {"w": torch.zeros(c.num_dims, device=device)}, data, eplan,
            steps=256, seed=0, record_every=1, sink=sink)
        return out, sink.records

    cx.zero_counts()
    t = time.perf_counter()
    (fg, hg), rg = ls_run(cx.dev)
    cx.sync()
    card_s = time.perf_counter() - t
    got = cx.read_counts({"opt_step": 256, "avg_disp": hg["averages"]},
                         "telemetry ls elastic")
    (fc, hc), rc = ls_run("cpu")
    check([r["type"] for r in rg] == [r["type"] for r in rc],
          "ls elastic records: types or order, card against CPU")
    exact = ("t0", "t1", "steps", "events", "events_inner", "events_all",
             "comm_bytes", "alive_min", "alive_mean", "straggle_rate")
    floats = ("loss_mean", "loss_max", "disp_mean", "disp_max")
    worst = 0.0
    for g, w in zip(rg, rc):
        if g["type"] == "phase_metrics":
            check({k: g[k] for k in exact} == {k: w[k] for k in exact},
                  f"ls elastic phase {g['t0']}-{g['t1']}: integer fields")
            pairs = [(g[k], w[k]) for k in floats] + [
                (a[1], b[1]) for key in ("loss_trace", "disp_trace")
                for a, b in zip(g[key], w[key])]
            check([a[0] for a in g["loss_trace"]]
                  == [b[0] for b in w["loss_trace"]],
                  "ls elastic: recorded steps")
        elif g["type"] == "averaging_event":
            check((g["step"], g["scope"]) == (w["step"], w["scope"]),
                  "ls elastic: averaging events")
            pairs = [(g["dispersion"], w["dispersion"])]
        else:
            check(g == w, f"ls elastic: {g} against {w}")
            pairs = []
        for a, b in pairs:
            check(_close(a, b, 1e-4, 1e-7),
                  f"ls elastic {g['type']}: {a} against {b}")
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    # the occupancy is the segment plans' streams'
    dec_key = rng.split(rng.PRNGKey(0))[1]
    occ = {}
    for seg in eplan.segments(256):
        fp = eplan.segment_faults(base_plan, seg.num_workers, seg.start,
                                  seg.stop)
        for t in range(seg.start, seg.stop):
            a = fp.alive_at(t)
            s = fp.straggle_mask(dec_key, t, np.arange(seg.num_workers))
            occ[t] = (float(a.sum()), float(np.sum(a * s)))
    phases = [r for r in rg if r["type"] == "phase_metrics"]
    for ph in phases:
        ts = range(ph["t0"], ph["t1"] + 1)
        a_sum = sum(occ[t][0] for t in ts)
        check(ph["alive_mean"] == a_sum / ph["steps"]
              and ph["alive_min"] == min(occ[t][0] for t in ts)
              and ph["straggle_rate"] == sum(occ[t][1] for t in ts) / a_sum,
              f"ls elastic phase {ph['t0']}-{ph['t1']}: occupancy")
    kinds = [r["type"] for r in rg]
    ls = dict(config=c.name, steps=256, records=len(rg),
              phase_metrics=kinds.count("phase_metrics"),
              averaging_events=kinds.count("averaging_event"),
              fault_events=kinds.count("fault_event"),
              resize_events=kinds.count("resize_event"),
              alive_min=min(p["alive_min"] for p in phases),
              straggle_rate_max=max(p["straggle_rate"] for p in phases),
              launches=got, card_s=card_s, max_rel_err=worst,
              cuda_vs_cpu="integer fields exact; losses, dispersions "
                          "rtol 1e-4 / atol 1e-7")
    check(ls["resize_events"] == 2 and ls["fault_events"] == 2,
          f"ls elastic events {ls}")
    del fg, hg, fc, hc
    cx.free()
    return {"phase": "telemetry", "cli": cli, "least_squares": ls,
            "wall_s": time.perf_counter() - t_ph}


def conv_gradients(cx, cfg, params, images, labels) -> dict | None:
    """The CNN's gradients on the card for one worker's batch at the init,
    against the float64 gradients on the CPU: the largest error of a
    leaf over its largest magnitude, and ms a forward / backward, for
    the port's convolution (``models/cnn.py``: an im2col product; gated
    at ``CNN_PLANE_TOL``) and for ``F.conv2d`` with cuDNN and without it
    (reported: cuDNN's parts by far more, which is why the port does not
    call it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import cnn as cnn_mod
    if cx.dev.type != "cuda":
        return None

    def lib_conv(x, p):
        return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"],
                        padding="same")

    def setup(device, dtype):
        p = {k: {n: v.to(device, dtype).clone().requires_grad_()
                 for n, v in d.items()} for k, d in params.items()}
        b = {"images": torch.from_numpy(images).to(device, dtype),
             "labels": torch.from_numpy(labels).to(device)}
        return p, b

    def grads(device, dtype):
        p, b = setup(device, dtype)
        cnn_mod.cnn_loss(cfg, p, b).backward()
        return {f"{k}.{n}": v.grad.detach().double().cpu()
                for k, d in p.items() for n, v in d.items()}

    want = grads("cpu", torch.float64)
    own = cnn_mod._conv
    out = {}
    try:
        for name, conv, cudnn in (("im2col", own, True),
                                  ("conv2d_cudnn", lib_conv, True),
                                  ("conv2d_no_cudnn", lib_conv, False)):
            cnn_mod._conv = conv
            with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False,
                                            deterministic=False,
                                            allow_tf32=False):
                got = grads(cx.dev, torch.float32)
                p, b = setup(cx.dev, torch.float32)
                ms = cx.cuda_time(
                    lambda: cnn_mod.cnn_loss(cfg, p, b).backward(), 50)
            out[name] = dict(max_scaled_err=max(
                float((got[k] - want[k]).abs().max() / want[k].abs().max())
                for k in want), fwd_bwd_ms=ms)
    finally:
        cnn_mod._conv = own
    check(out["im2col"]["max_scaled_err"] <= CNN_PLANE_TOL,
          f"the CNN's gradients on the card against float64: {out}")
    return out


def _leaves(tree) -> list:
    from repro_torch.core.flat import tree_flatten
    return tree_flatten(tree)[0]


def phase_convex_curves(cx) -> dict:
    """Phase 5's curves: for each config of ``CONVEX_SUITE`` at its full
    size, w* and its checks, Table 1's row (``experiments.table1``) and
    Figure 2's paired-draw curves (``experiments.fig2_convex.sgd_curves``,
    its engine wrapped to count each curve's launches alone)."""
    import torch
    from repro_torch.configs.paper import CONVEX_SUITE
    from repro_torch.data import convex_dataset
    from repro_torch.experiments import fig2_convex, table1
    from repro_torch.models.convex import (full_gradient, make_problem,
                                           solve_optimum)

    dev = cx.dev
    phase_lens = (0, 1, SUITE_STEPS // 2, SUITE_STEPS)
    engine_cls = fig2_convex.PhaseEngine
    curve_runs, cur = [], {}

    class CountedEngine(engine_cls):
        def run(self, params, data, *, num_workers, **kw):
            sched = self.schedule
            # the minibatch schedule fuses its event into opt_step
            events = {"minibatch": SUITE_STEPS,
                      "periodic": SUITE_STEPS // sched.phase_len}.get(
                          sched.kind, 0)
            launches = events if sched.kind == "periodic" else 0
            what = f"{cur['name']} {sched.kind} M={num_workers}"
            cx.zero_counts()
            final, hist = super().run(params, data, num_workers=num_workers,
                                      **kw)
            got = cx.read_counts({"opt_step": SUITE_STEPS,
                                  "avg_disp": launches}, what)
            check(hist["averages"] == events,
                  f"{what}: {hist['averages']} events")
            evals = [v for _, v in hist["eval"]]
            check([t for t, _ in hist["eval"]]
                  == list(range(SUITE_EVERY, SUITE_STEPS + 1, SUITE_EVERY))
                  and all(map(math.isfinite, evals)),
                  f"{what}: evals {hist['eval']}")
            curve_runs.append(dict(
                workers=num_workers, events=hist["averages"],
                event_steps=[t for t, _ in hist["dispersion"]][:8],
                launches={k: got[k] for k in ("opt_step", "avg_disp")},
                steady_step_ms=steady_step_ms(hist["phase_wall"])))
            return final, hist

    suite = {}
    fig2_convex.PhaseEngine = CountedEngine
    try:
        for c in CONVEX_SUITE:
            cur["name"] = c.name
            X, y, _ = convex_dataset(c.model, c.num_samples, c.num_dims,
                                     sparsity=c.sparsity, noise=c.noise,
                                     seed=0)
            Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
            obj = make_problem(c.model)[0]
            w0 = torch.zeros(c.num_dims, device=dev)
            t0 = time.perf_counter()
            w_star = solve_optimum(c.model, Xd, yd)
            cx.sync()
            solve_ms = (time.perf_counter() - t0) * 1e3
            g_ratio = float(
                torch.linalg.norm(full_gradient(c.model, w_star, Xd, yd))
                / torch.linalg.norm(full_gradient(c.model, w0, Xd, yd)))
            check(g_ratio < 0.05, f"{c.name}: w* gradient ratio {g_ratio}")
            f0, fstar = float(obj(w0, Xd, yd)), float(obj(w_star, Xd, yd))
            check(fstar < f0, f"{c.name}: f* {fstar} not below f(0) {f0}")
            # Table 1's row at the suite's full size
            t0 = time.perf_counter()
            row = table1.table1_row(c, c.num_samples, c.num_dims, device=dev)
            table1_s = time.perf_counter() - t0
            sigma2, beta2, rho_ = row["sigma2"], row["beta2"], row["rho"]
            check(all(map(math.isfinite, (beta2, sigma2, rho_)))
                  and beta2 > 0,
                  f"{c.name}: beta2 {beta2}, sigma2 {sigma2}, rho {rho_}")
            # paired draws (default_rng(0)): worker w of every curve takes
            # idx[:, w]; the rate as grid_curves takes it
            meansq = float(torch.mean(torch.sum(Xd * Xd, dim=1)))
            curve_runs.clear()
            t0 = time.perf_counter()
            curves = fig2_convex.sgd_curves(
                c.model, Xd, yd, workers=c.num_workers, steps=SUITE_STEPS,
                phase_lens=list(phase_lens),
                lr0=SUITE_LR_MULT * SUITE_LR_D / meansq, lr_d=SUITE_LR_D,
                seed=0, record_every=SUITE_EVERY, device=str(dev))
            curves_s = time.perf_counter() - t0
            check(list(curves) == ["oneshot", "minibatch",
                                   f"periodic_{SUITE_STEPS // 2}",
                                   f"periodic_{SUITE_STEPS}", "single"]
                  and [r["workers"] for r in curve_runs]
                  == [c.num_workers] * 4 + [1],
                  f"{c.name}: curves {list(curves)}")
            out = {}
            for (name, sub), run in zip(curves.items(), curve_runs):
                out[name] = dict(run, subopt=sub, subopt_end=sub[-1][1])
                check(name == "single" or sub[-1][1] < 1.0,
                      f"{c.name} {name}: no progress, {sub[-1][1]}")
            suite[c.name] = dict(samples=c.num_samples, dims=c.num_dims,
                                 workers=c.num_workers, f0=f0, f_star=fstar,
                                 w_star_grad_ratio=g_ratio,
                                 solve_optimum_ms=solve_ms, sigma2=sigma2,
                                 beta2=beta2, rho=rho_, table1_row_s=table1_s,
                                 sgd_curves_s=curves_s, curves=out)
            del Xd, yd, w_star
            cx.free()
    finally:
        fig2_convex.PhaseEngine = engine_cls
    return suite


def phase_paper_cnn(cx) -> dict:
    """Phase 10: the paper's §3.2 CNN (Fig. 3) at ``CNNConfig``'s widths
    through the engine, periodic-10 and oneshot, card against CPU over
    the first steps, the kernels at its shape; then the theory module's
    Lemma 1 simulation on the card against the closed form and the
    CPU."""
    import torch
    from repro_torch import rng
    from repro_torch.configs.paper import CNNConfig, QuadraticConfig
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.core import engine as engine_mod
    from repro_torch.data import DeviceDataset, mnist_like
    from repro_torch.experiments import fig3_cnn, lemma1
    from repro_torch.kernels import avg_disp as avg_mod
    from repro_torch.kernels import opt_step as opt_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import card_check as cc
    from repro_torch.launch.profile import _breakdown, _profiler
    from repro_torch.models import cnn_loss, init_cnn
    from repro_torch.optim import Momentum, schedules

    t_ph = time.perf_counter()
    cfg = CNNConfig()
    m, steps = cfg.num_workers, cx.cnn_steps
    images, labels = mnist_like(CNN_TRAIN, seed=0, noise=CNN_NOISE)
    arrays = {"images": images, "labels": labels}
    params0 = init_cnn(cfg, rng.PRNGKey(0), device="cpu")
    spe = CNN_TRAIN // (m * cfg.batch_size)
    epoch_lr = schedules.exponential_epoch(cfg.lr, cfg.lr_decay_per_epoch,
                                           spe)

    def engine(sched, device):
        return PhaseEngine(lambda p, b, r: (cnn_loss(cfg, p, b), {}),
                           Momentum(lr=lambda t: epoch_lr(t - 1),
                                    mu=cfg.momentum),
                           sched, device=device)

    def sched_of(k):
        return (AveragingSchedule("periodic", phase_len=k) if k
                else AveragingSchedule("oneshot"))

    dev = cx.dev

    # every way the card path could reach a plain version, counted where it
    # is handed a tensor on the card
    plain = {"calls": 0}

    def counted(fn):
        def run(*a, **k):
            if any(isinstance(v, torch.Tensor) and v.is_cuda for v in a):
                plain["calls"] += 1
            return fn(*a, **k)
        return run
    patched = [(opt_mod, "opt_step_ref"), (avg_mod, "plane_average_ref")]
    saved = [getattr(mod, n) for mod, n in patched]
    saved_ops = dict(engine_mod._PLAIN_OPS)
    for mod, n in patched:
        setattr(mod, n, counted(getattr(mod, n)))
    for k in engine_mod._PLAIN_OPS:
        engine_mod._PLAIN_OPS[k] = counted(saved_ops[k])
    runs, kept = {}, {}

    class CountedEngine(fig3_cnn.PhaseEngine):
        """run_cnn's engine: each schedule's launches counted alone, its
        history, dataset and final state kept."""
        def run(self, params, data, *, num_workers, **kw):
            k = self.schedule.phase_len if self.schedule.kind == "periodic" \
                else 0
            name = "periodic" if k else "oneshot"
            ev = steps // k if k else 0
            cx.zero_counts()
            t = time.perf_counter()
            final, hist, st = super().run(params, data,
                                          num_workers=num_workers,
                                          return_state=True, **kw)
            cx.sync()
            wall = time.perf_counter() - t
            got = cx.read_counts({"opt_step": steps, "avg_disp": ev},
                                 f"cnn {name}")
            check(hist["averages"] == ev, f"cnn {name}: {hist['averages']}")
            loss_f, err_f = hist["eval"][-1][1]
            check(math.isfinite(loss_f) and 0.0 <= err_f <= 1.0,
                  f"cnn {name}: final eval {hist['eval'][-1]}")
            runs[name] = dict(
                averages=ev, launches=got, wall_s=wall,
                step_ms=steady_step_ms(hist["phase_wall"]),
                train_loss=loss_f, test_error=err_f,
                best_worker_loss=hist["worker_eval"][-1][1][0],
                worst_worker_loss=hist["worker_eval"][-1][1][1],
                eval=[(t_, a, b) for t_, (a, b) in hist["eval"]])
            kept[name] = (data, st)
            return final, hist

    fig3_cnn.PhaseEngine = CountedEngine
    try:
        # Figure 3 through the experiment: one dataset for both schedules,
        # the second run continuing the permutation cursors
        t = time.perf_counter()
        curves = fig3_cnn.run_cnn(cfg, steps, seed=0,
                                  record_every=CNN_EVERY, eval_n=CNN_TEST,
                                  noise=CNN_NOISE, device=dev)
        run_cnn_s = time.perf_counter() - t
        check(list(curves) == ["periodic", "oneshot"] == list(runs)
              and all(curves[n]["avg"] == runs[n]["eval"] for n in curves),
              f"run_cnn returned {list(curves)}, ran {list(runs)}")
        data, state = kept.pop("periodic")
        kept.clear()
        # where a step's time goes: 20 steps unprofiled, 20 profiled
        eng = engine(sched_of(cfg.phase_len), dev)
        cx.zero_counts()
        cx.sync()
        t = time.perf_counter()
        _, _, state = eng.run(None, data, num_workers=m, steps=20,
                              state=state, phase_len=10, return_state=True)
        cx.sync()
        step_us = (time.perf_counter() - t) * 1e6 / 20
        prof_bd = None
        if dev.type == "cuda":
            with _profiler() as prof:
                eng.run(None, data, num_workers=m, steps=20, state=state,
                        phase_len=10)
                cx.sync()
            prof_bd = {k: v for k, v in _breakdown(prof, 20, step_us).items()
                       if k in ("device_busy_ms", "idle_share",
                                "kernels_per_step", "by_group_ms")}
        cx.read_counts({"opt_step": 40, "avg_disp": 4}, "cnn profile")
        # the first steps on the card against the CPU, each step from the
        # CPU's state: the recipe's first steps are violent (the loss
        # climbs from 2.8 to 12 at step 2), and training amplifies the
        # last bits in which two runs part, so a common state each step
        # holds the card's step itself; a free-running card run beside the
        # CPU's is reported
        idx = DeviceDataset(arrays, m, batch_size=cfg.batch_size, seed=0,
                            mode="permute",
                            device="cpu").index_block(CNN_PARITY_STEPS)
        eng_g, eng_c = (engine(sched_of(cfg.phase_len), d)
                        for d in (dev, "cpu"))
        ds_g, ds_c = (DeviceDataset(arrays, m, indices=idx, device=d)
                      for d in (dev, "cpu"))
        st_c = eng_c.init(params0, m, 0)
        cx.zero_counts()
        loss_err, plane_err, plane_far, flip_steps = 0.0, [0.0, 0.0], \
            [0.0, 0.0], 0
        ev_g, ev_c, loss_c = [], [], []
        t = time.perf_counter()
        for _ in range(CNN_PARITY_STEPS):
            st_g = st_c._replace(plane=st_c.plane.to(dev), opt_planes=tuple(
                p.to(dev) for p in st_c.opt_planes))
            _, hg, st_g = eng_g.run(None, ds_g, num_workers=m, steps=1,
                                    state=st_g, record_every=1,
                                    return_state=True)
            _, hc, st_c = eng_c.run(None, ds_c, num_workers=m, steps=1,
                                    state=st_c, record_every=1,
                                    return_state=True)
            ev_g += hg["dispersion"]
            ev_c += hc["dispersion"]
            (tg, lg), (tc, lc) = hg["loss"][0], hc["loss"][0]
            check(tg == tc and _close(lg, lc, CNN_LOSS_RTOL),
                  f"cnn step {tc}: loss on the card {lg}, on the CPU {lc}")
            loss_err = max(loss_err, abs(lg - lc) / abs(lc))
            loss_c.append(lc)
            for j, (a, b) in enumerate(zip((st_g.plane,) + st_g.opt_planes,
                                           (st_c.plane,) + st_c.opt_planes)):
                d = (a.cpu() - b).abs() / b.abs().max()
                far = float((d > CNN_PLANE_TOL).float().mean())
                check(far <= CNN_FLIP_FRAC,
                      f"cnn step {tc}: {('params', 'velocity')[j]} plane, "
                      f"card against CPU: {far} of it beyond "
                      f"{CNN_PLANE_TOL} of its scale")
                plane_err[j] = max(plane_err[j], float(d.max()))
                plane_far[j] = max(plane_far[j], far)
                flip_steps += far > 0
        parity_s = time.perf_counter() - t
        _, h_free = eng_g.run(
            params0, DeviceDataset(arrays, m, indices=idx, device=dev),
            num_workers=m, seed=0, record_every=1, phase_len=CNN_EVERY)
        free = [abs(v - c) / abs(c) for (_, v), c in zip(h_free["loss"],
                                                        loss_c)]
        cx.read_counts({"opt_step": 2 * CNN_PARITY_STEPS,
                        "avg_disp": 2 * CNN_PARITY_STEPS // cfg.phase_len},
                       "cnn parity")
        check([t_ for t_, _ in ev_g] == [t_ for t_, _ in ev_c]
              and all(_close(a, b, CNN_LOSS_RTOL) for (_, a), (_, b)
                      in zip(ev_g, ev_c)),
              f"cnn: events, card {ev_g} against CPU {ev_c}")
        card_plain = plain["calls"]
    finally:
        fig3_cnn.PhaseEngine = PhaseEngine
        for (mod, n), fn in zip(patched, saved):
            setattr(mod, n, fn)
        engine_mod._PLAIN_OPS.update(saved_ops)
    if dev.type == "cuda":
        check(card_plain == 0,
              f"the CNN's card runs called a plain version {card_plain}x")
    parity = dict(steps=CNN_PARITY_STEPS, wall_s=parity_s,
                  events=[t_ for t_, _ in ev_g], loss_max_rel_err=loss_err,
                  params_max_scaled_err=plane_err[0],
                  params_max_far_share=plane_far[0],
                  velocity_max_far_share=plane_far[1],
                  planes_with_far_elements=flip_steps,
                  free_running_loss_rel_err=free,
                  velocity_max_scaled_err=plane_err[1],
                  tolerance=f"each step from the CPU's state: losses rtol "
                            f"{CNN_LOSS_RTOL}; at most {CNN_FLIP_FRAC} of a "
                            f"plane beyond {CNN_PLANE_TOL} of its largest "
                            "magnitude; TF32 off")
    del st_g, st_c, data, state, ds_g, ds_c
    cx.free()

    # opt_step and avg_disp at the CNN's plane: M=4 x P, Momentum, f32
    p_width = sum(x.numel() for x in _leaves(params0))
    x, g, st, scal, _ = cc.make_inputs(dev, m, p_width, "momentum", seed=11,
                                       scale=1e-3)
    kernels = {}
    if dev.type == "cuda":
        from repro_torch.kernels.avg_disp import avg_disp
        from repro_torch.kernels.opt_step import opt_step
        # each held against its plain version at this shape first
        err_opt = cc.check_opt_step("opt_step/cnn-momentum-none", x, g, st,
                                    scal, None, kind="momentum", mu=0.9,
                                    mode="none")[0]
        xk, sk = x.clone(), tuple(s.clone() for s in st)
        k_ms = cx.cuda_time(lambda: opt_step(xk, g, sk, scal, kind="momentum",
                                             mu=0.9, mode="none"), 200)
        p_ms = cx.cuda_time(lambda: ref.opt_step_ref(
            x, g, st, scal, kind="momentum", mu=0.9, mode="none"), 20)
        b_ms, b_by = bound_ms(*opt_step_cost(m, p_width, "momentum", False))
        kernels["opt_step"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                   bound_by=b_by, max_abs_err=err_opt)
        err_avg = cc.check_avg_disp("avg_disp/cnn", xk.clone(), 1)
        # the event split: CUDA events per call (ms), the host path, the
        # device time of calls queued back to back (phase 2 traces the
        # same plane's kernels)
        split = call_split(lambda: avg_disp(xk, groups=1), 200, 50)
        k_ms = split.pop("ms")
        p_ms = cx.cuda_time(lambda: ref.plane_average_ref(x, groups=1), 20)
        b_ms, b_by = bound_ms(*avg_disp_cost(m, p_width))
        kernels["avg_disp"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                   bound_by=b_by, max_abs_err=err_avg,
                                   device_bound_share=b_ms * 1e3
                                   / split["device_us"], **split)
        del xk, sk
    del x, g, st
    cx.free()
    conv_grads = conv_gradients(cx, cfg, params0, images[:cfg.batch_size],
                                labels[:cfg.batch_size])
    pr, on = runs["periodic"], runs["oneshot"]
    fig3 = dict(
        oneshot_worse_than_worst_worker=on["train_loss"]
        > on["worst_worker_loss"],
        periodic_beats_best_worker=pr["train_loss"]
        <= pr["best_worker_loss"] + 1e-6)

    # Lemma 1 through the experiment on the card, against its closed form
    # and against the CPU's run of the same draws
    q = QuadraticConfig()
    sims, card_s = lemma1.lemma1_rows(q, reps=cx.lemma_reps, device=dev)
    twins, _ = lemma1.lemma1_rows(q, reps=LEMMA1_CPU_REPS, seed=1,
                                  device=dev)
    twins_cpu, cpu_s = lemma1.lemma1_rows(q, reps=LEMMA1_CPU_REPS, seed=1,
                                          device="cpu")
    lemma = []
    for row, secs, twin, twin_cpu, s_cpu in zip(sims, card_s, twins,
                                                twins_cpu, cpu_s):
        z, small, small_cpu = row["zeta"], twin["simulated"], \
            twin_cpu["simulated"]
        check(_close(small, small_cpu, 1e-4),
              f"simulate_quadratic zeta={z}: card {small} against CPU "
              f"{small_cpu}")
        if z in LEMMA1_GATED:
            check(row["rel_err"] < 0.15,
                  f"Lemma 1 zeta={z}: simulated {row['simulated']}, "
                  f"closed form {row['lemma1']}")
        lemma.append(dict(row, card_s=secs, cpu_twin=small_cpu,
                          card_twin=small, cpu_twin_s=s_cpu))
    return {"phase": "paper_cnn", "config": dataclasses.asdict(cfg),
            "params": p_width, "steps": steps, "eval_every": CNN_EVERY,
            "data": dict(train=CNN_TRAIN, test=CNN_TEST, noise=CNN_NOISE,
                         mode="permute"),
            **runs, "profile": prof_bd, "step_us_unprofiled": step_us,
            "cuda_vs_cpu": parity, "kernels_at_cnn_shape": kernels,
            "plain_calls_on_card": card_plain, "conv_gradients": conv_grads,
            "fig3": fig3,
            "run_cnn_s": run_cnn_s,
            "theory": dict(config=dataclasses.asdict(q), steps=lemma1.STEPS,
                           reps=cx.lemma_reps, cpu_twin_reps=LEMMA1_CPU_REPS,
                           cuda_vs_cpu="rtol 1e-4", gated_zetas=LEMMA1_GATED,
                           gate="rel 0.15", rows=lemma),
            "wall_s": time.perf_counter() - t_ph}


# ---- phase 10 (b): Figure 1 and the quartic --------------------------------
#: phase 10 (b)'s budget, printed before it starts; bench_fig1_pca.run's
#: config and phase lengths; bench_quartic.run's fractions (QuarticConfig:
#: the paper's 24 workers, 10,000 steps)
NONCONVEX_BUDGET_S = 15.0
FIG1_PCA = dict(num_workers=24, num_samples=4000, alpha=0.02)
FIG1_LENS = (0, 2000, 500, 100, 25, 5)
QUARTIC_FRACS = (0.0, 0.001, 0.01, 0.1)
#: the card against the CPU on the same draws: Figure 1's PC errors (float64
#: on both; norms and means summed in other orders) at rtol FIG1_RTOL; the
#: quartic's objectives at rtol QUARTIC_RTOL: 10,000 float32 steps whose
#: 24-worker means are summed in other orders, and (w̄² - 1)² near w̄ = ±1
#: multiplies w̄'s relative error by 4 w̄² / |w̄² - 1| (about 100 at the
#: 1% and 10% points)
FIG1_RTOL, QUARTIC_RTOL = 1e-9, 1e-3


def kernel_launches(fn) -> tuple:
    """(``fn()``, the kernels the card ran for it, and its other device
    events: copies and fills), counted by one run under ``torch.profiler``
    with only the CUDA activity. The profiler's raw events are read: its
    ``events()`` builds a Python object for each, some 0.1 ms apiece, which
    at these runs' 10^4-10^5 kernels would take longer than the runs."""
    import torch
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    other = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    return out, len(names) - other, other


def phase_paper_nonconvex(cx) -> dict:
    """Phase 10 (b): Figure 1 (Oja's rule) and the §2.4 quartic through
    ``repro_torch.experiments`` at ``bench_fig1_pca.run``'s and
    ``bench_quartic.run``'s sizes on the card, each against the port's
    CPU run of the same draws: wall seconds on both, and the kernels a
    run on the card (one more run, under the profiler)."""
    from repro_torch import rng
    from repro_torch.configs.paper import PCAConfig, QuarticConfig
    from repro_torch.experiments import fig1_pca, quartic

    emit({"phase": "paper_nonconvex", "budget_s": NONCONVEX_BUDGET_S})
    t_ph = time.perf_counter()
    dev = cx.dev

    def timed(fn):
        cx.sync()
        t = time.perf_counter()
        out = fn()
        cx.sync()
        return out, time.perf_counter() - t

    pca = PCAConfig(**FIG1_PCA)

    def fig1(device):
        return fig1_pca.pca_error_vs_avg_steps(pca, FIG1_LENS,
                                               device=device)
    rows, card_s = timed(lambda: fig1(dev))
    rows_cpu, cpu_s = timed(lambda: fig1("cpu"))
    for key in ("phase_len", "num_avg_steps"):
        check([r[key] for r in rows] == [r[key] for r in rows_cpu],
              f"fig1 {key}: card {rows}, CPU {rows_cpu}")
    errs = [abs(a["pc_error"] - b["pc_error"]) / abs(b["pc_error"])
            for a, b in zip(rows, rows_cpu)]
    check(max(errs) <= FIG1_RTOL, f"fig1 PC errors: card {rows}, CPU "
                                  f"{rows_cpu}")
    _, launches, other = kernel_launches(lambda: fig1(dev))
    fig1_out = dict(config=FIG1_PCA, phase_lens=FIG1_LENS, rows=rows,
                    card_s=card_s, cpu_s=cpu_s, pc_error_max_rel_err=errs,
                    launches_a_run=launches or None,
                    other_device_events_a_run=other,
                    oneshot_worst=rows[0]["pc_error"]
                    >= max(r["pc_error"] for r in rows[1:]))

    q = QuarticConfig()
    u = rng.normal(rng.PRNGKey(0), (q.num_steps, q.num_workers), device=dev)
    rows, card_s = timed(lambda: quartic.run_quartic(q, QUARTIC_FRACS,
                                                     device=dev))
    # the CPU on the card's own draw of u (run_quartic draws the same)
    rows_cpu, cpu_s = timed(lambda: quartic.run_quartic(
        q, QUARTIC_FRACS, device="cpu", u=u.cpu().numpy()))
    errs = [abs(a["objective"] - b["objective"]) / abs(b["objective"])
            for a, b in zip(rows, rows_cpu)]
    check([r["avg_frac"] for r in rows] == list(QUARTIC_FRACS)
          and max(errs) <= QUARTIC_RTOL,
          f"quartic: card {rows}, CPU {rows_cpu}")
    _, launches, other = kernel_launches(lambda: quartic.run_quartic(
        q, QUARTIC_FRACS, device=dev))
    quartic_out = dict(config=dataclasses.asdict(q), rows=rows,
                       card_s=card_s, cpu_s=cpu_s,
                       objective_max_rel_err=errs,
                       launches_a_run=launches or None,
                       other_device_events_a_run=other,
                       paper={"oneshot": 0.922, "0.001": 0.274,
                              "0.1": 0.011})
    wall = time.perf_counter() - t_ph
    return {"phase": "paper_nonconvex", "budget_s": NONCONVEX_BUDGET_S,
            "fig1_pca": fig1_out, "quartic": quartic_out,
            "tolerance": f"card vs CPU on the same draws: PC errors rtol "
                         f"{FIG1_RTOL}, quartic objectives rtol "
                         f"{QUARTIC_RTOL}",
            "launches": "kernels of one more run on the card, read from "
                        "torch.profiler's raw events (null: the profiler "
                        "saw none)",
            "wall_s": wall, "within_budget": wall <= NONCONVEX_BUDGET_S}


# ---- phase 11: the sharded plane ------------------------------------------
#: (a) the least squares of phase 4 on SHARD_LS_RANKS gloo ranks sharing
#: the card, SHARD_LS_STEPS steps a run, in phases of 16; (b) smollm-360m
#: at full width on SHARD_LM_RANKS ranks; the fault plan crashes rows of
#: two of the four ranks (6 rows each) and rejoins one, stragglers on all
SHARD_LS_RANKS, SHARD_LS_STEPS = 4, 64
SHARD_LM_RANKS = 2
SHARD_FAULTS = "crash:m=3@t=20,crash:m=13@t=20,rejoin:m=3@t=45"
SHARD_LS_RUNS = {
    "periodic-8": dict(sched=dict(kind="periodic", phase_len=8)),
    "stochastic": dict(sched=dict(kind="stochastic", zeta=0.1)),
    "ring-int8-faults": dict(sched=dict(kind="periodic", phase_len=16),
                             topology="ring", wire="int8", faults=True),
}
#: the CLI of phase 3's periodic run (smollm-360m, 4 workers, bf16)
LM_ARGV = ["--arch", "smollm-360m", "--workers", "4", "--batch", "4",
           "--seq", "64", "--optimizer", "momentum", "--lr", "0.01",
           "--device", "cuda", "--steps", "4", "--avg", "periodic",
           "--phase-len", "2"]


def _kernel_wrappers() -> dict:
    from repro_torch.kernels.avg_disp import (avg_disp, avg_disp_outer,
                                              compressed_mix, mix_disp)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.opt_step import opt_step
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    return {"opt_step": opt_step, "avg_disp": avg_disp,
            "mix_disp": mix_disp, "avg_disp_outer": avg_disp_outer,
            "compressed_mix": compressed_mix,
            "flash_attention": flash_attention, "rglru_scan": rglru_scan,
            "rwkv6_scan": rwkv6_scan}


def _strip(hist: dict) -> dict:
    return {k: v for k, v in hist.items() if k != "phase_wall"}


def shard_ls_run(name: str, **engine_kw):
    """Run ``name`` of SHARD_LS_RUNS on the card: phase 4's least squares
    (24 workers, SGD on lr0 / (t - 1 + d)) through a DeviceDataset, a
    sharded run with ``mesh=`` / ``collective=``. Returns (final, hist,
    state)."""
    import numpy as np
    import torch
    from repro_torch.configs.paper import CONVEX_SUITE
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.core.compress import Compression
    from repro_torch.data import DeviceDataset, convex_dataset
    from repro_torch.faults import FaultPlan
    from repro_torch.models.convex import make_problem
    from repro_torch.optim import SGD
    from repro_torch.topology import Topology

    c = CONVEX_SUITE[0]
    mw = c.num_workers
    X, y, _ = convex_dataset(c.model, c.num_samples, c.num_dims,
                             sparsity=c.sparsity, noise=c.noise, seed=0)
    lr0 = 0.8 * 200.0 / float(np.mean(np.sum(X * X, axis=1)))
    obj = make_problem("ls")[0]

    def loss(p, b, r):
        w = p["w"]
        return obj(w, b["x"].reshape(-1, w.shape[0]), b["y"].reshape(-1)), {}

    run = SHARD_LS_RUNS[name]
    kw = dict(schedule=AveragingSchedule(**run["sched"]))
    if "topology" in run:
        kw["topology"] = Topology.build(run["topology"], mw)
    if "wire" in run:
        kw["compression"] = Compression(run["wire"])
    if run.get("faults"):
        kw["faults"] = FaultPlan.parse(SHARD_FAULTS, mw, straggle_prob=0.1,
                                       rejoin_curriculum=8)
    idx = np.random.default_rng(5).integers(0, c.num_samples,
                                            (SHARD_LS_STEPS, mw))
    data = DeviceDataset({"x": torch.from_numpy(X).cuda(),
                          "y": torch.from_numpy(y).cuda()}, mw, indices=idx,
                         device="cuda")
    eng = PhaseEngine(loss, SGD(lr=lambda t: lr0 / (t - 1.0 + 200.0)),
                      device="cuda", **kw, **engine_kw)
    return eng.run({"w": torch.zeros(c.num_dims, device="cuda")}, data,
                   num_workers=mw, seed=0, record_every=1, phase_len=16,
                   return_state=True)


def _shard_ls_rank(rank: int) -> dict:
    """A rank of phase 11 (a): every run under both collectives, with
    its launches, step ms and collective seconds."""
    import torch
    from repro_torch.launch.mesh import make_worker_mesh
    mesh = make_worker_mesh(24, backend="gloo", device="cuda")
    kernels = _kernel_wrappers()
    out = {"rows": mesh.row_range(24)}
    for name in SHARD_LS_RUNS:
        for coll in ("gather", "psum"):
            for k in kernels.values():
                k.launches = 0
            mesh.reset_stats()
            t0 = time.perf_counter()
            final, hist, state = shard_ls_run(name, mesh=mesh,
                                              collective=coll)
            torch.cuda.synchronize()
            out[(name, coll)] = dict(
                w=final["w"].cpu().numpy(), hist=_strip(hist),
                launches={n: k.launches for n, k in kernels.items()},
                step_ms=steady_step_ms(hist["phase_wall"]),
                wall_s=time.perf_counter() - t0,
                collectives={op: dict(st, ms_per_step=1e3 * st["seconds"]
                                      / SHARD_LS_STEPS)
                             for op, st in mesh.read_stats().items()})
            del final, state
    return out


def _shard_lm_rank(rank: int, workdir: str) -> dict:
    """A rank of phase 11 (b): phase 3's periodic run of smollm-360m with
    its 4 worker rows over SHARD_LM_RANKS ranks (psum): peak memory, step
    ms, the collectives' seconds; the local column-sum,
    squared-distance and broadcast passes timed on the rank's rows, and
    a bf16 wire's encode of one row; rank 0 saves the consensus."""
    import torch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_worker_mesh
    dev = torch.device("cuda", 0)
    kernels = _kernel_wrappers()
    ap = train.make_parser()
    args = ap.parse_args(LM_ARGV)
    _, engine, params, batches = train.setup(args, ap)
    mesh = make_worker_mesh(args.workers, backend="gloo", device="cuda")
    eng = dataclasses.replace(engine, mesh=mesh, collective="psum")
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    final, hist, state = eng.run(params, batches(), num_workers=args.workers,
                                 seed=args.seed, record_every=1,
                                 return_state=True)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    steps = args.steps
    res = dict(rows=mesh.row_range(args.workers), hist=_strip(hist),
               launches={n: k.launches for n, k in kernels.items()},
               step_ms=steady_step_ms(hist["phase_wall"]), wall_s=wall,
               peak_gb=peak,
               collectives={op: dict(st, ms_per_call=1e3 * st["seconds"]
                                     / st["calls"])
                            for op, st in mesh.read_stats().items()},
               steps=steps)
    plane = state.plane

    def timed(fn, iters=3):
        fn()
        torch.cuda.synchronize(dev)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / iters

    glob = eng._col_sum(plane)

    def sq_dist():
        acc = torch.zeros((), device=dev)
        for i in range(plane.shape[0]):
            d = plane[i] - glob
            acc = acc + torch.dot(d, d)
        return acc
    res["col_sum_ms"] = timed(lambda: eng._col_sum(plane))
    res["sq_dist_ms"] = timed(sq_dist)
    # the all-worker mean written to the rows, and a wire's row-local
    # encode (bf16, error feedback) of one row
    res["broadcast_ms"] = timed(
        lambda: eng._write_rows(plane, glob.expand_as(plane)))
    from repro_torch.core.compress import encode_decode
    one, resid = plane[:1], torch.zeros_like(plane[:1])
    res["encode_row_ms"] = timed(
        lambda: encode_decode(one, resid, wire="bf16"))
    del resid
    if rank == 0:
        torch.save([v.cpu() for v in torch.utils._pytree.tree_leaves(final)],
                   Path(workdir) / "lm-final.pt")
    return res


def _shard_rank(rank: int, world: int, workdir: str, job: str) -> None:
    """One spawned rank of phase 11: joins the gloo group over a file in
    ``workdir`` (300 s per collective at most), runs ``job`` and pickles
    its results (or its traceback) to ``workdir``."""
    import datetime
    import pickle
    import traceback
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir}/{job}-rendezvous",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=300))
        out = (_shard_ls_rank(rank) if job == "ls"
               else _shard_lm_rank(rank, workdir))
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    with open(Path(workdir) / f"{job}-rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    if "error" in out:
        raise SystemExit(1)


def spawn_ranks(job: str, world: int, workdir: str, timeout: float) -> list:
    """``world`` ranks of ``job`` started with ``torch.multiprocessing``
    (spawn); every one still running at ``timeout`` seconds is killed.
    Returns each rank's results; a rank's failure raises with its
    traceback."""
    import pickle
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(_shard_rank, args=(world, workdir, job),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout
    failure = None
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                failure = f"{job}: ranks still running after {timeout} s"
                break
    except Exception as e:  # a rank exited non-zero
        failure = f"{job}: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r in range(world):
        path = Path(workdir) / f"{job}-rank{r}.pkl"
        res = pickle.load(open(path, "rb")) if path.exists() else {
            "error": "no result"}
        if "error" in res:
            failure = (failure or job) + f"\nrank {r}: {res['error']}"
        results.append(res)
    check(failure is None, str(failure))
    return results


def phase_sharded(cx) -> dict:
    """Phase 11: the sharded plane. (a) the least squares on 4 gloo ranks
    sharing the card against the unsharded card run (gather bitwise, psum
    the same decisions within rtol 1e-5 / atol 1e-7); (b) smollm-360m at
    full width on 2 ranks (psum) against phase 3's periodic run: the
    same decisions and losses, the consensus bitwise (as measured); (c)
    the CLI's ``--shard --collective gather`` under ``torchrun`` with
    one NCCL rank, bitwise the unsharded CLI."""
    import os
    import tempfile

    import numpy as np
    import torch
    t_ph = time.perf_counter()
    out = {}
    cx.free()
    with tempfile.TemporaryDirectory() as td:
        # ---- (a) the least squares over 4 ranks --------------------------
        tp = time.perf_counter()
        base = {}
        for name in SHARD_LS_RUNS:
            cx.zero_counts()
            final, hist, _ = shard_ls_run(name)
            kname = ("compressed_mix" if "wire" in SHARD_LS_RUNS[name]
                     else "avg_disp")
            got = cx.read_counts({"opt_step": SHARD_LS_STEPS,
                                  kname: hist["averages"]}, name)
            base[name] = dict(w=final["w"].cpu().numpy(), hist=hist,
                              launches=got)
            del final
        ranks = spawn_ranks("ls", SHARD_LS_RANKS, td, timeout=600)
        ls = {"ranks": SHARD_LS_RANKS, "steps": SHARD_LS_STEPS,
              "faults": SHARD_FAULTS, "straggle_prob": 0.1,
              "rows": [r["rows"] for r in ranks],
              "unsharded_step_ms": {n: steady_step_ms(b["hist"]["phase_wall"])
                                    for n, b in base.items()}}
        for name, b in base.items():
            want_h = _strip(b["hist"])
            kname = ("compressed_mix" if "wire" in SHARD_LS_RUNS[name]
                     else "avg_disp")
            for coll in ("gather", "psum"):
                runs = [r[(name, coll)] for r in ranks]
                first = runs[0]
                check(all(r["hist"] == first["hist"]
                          and np.array_equal(r["w"], first["w"])
                          for r in runs),
                      f"{name} {coll}: the ranks' runs differ")
                if coll == "gather":
                    check(np.array_equal(first["w"], b["w"])
                          and first["hist"] == want_h,
                          f"{name} gather: not bitwise the unsharded run")
                    expect = {"opt_step": SHARD_LS_STEPS,
                              kname: want_h["averages"]}
                else:
                    check(first["hist"]["averages"] == want_h["averages"]
                          and [t for t, _ in first["hist"]["dispersion"]]
                          == [t for t, _ in want_h["dispersion"]],
                          f"{name} psum: decisions differ")
                    expect = {"opt_step": SHARD_LS_STEPS}
                rel = float(np.max(np.abs(first["w"] - b["w"])
                                   / (np.abs(b["w"]) + 1e-30)))
                ok = bool(np.allclose(first["w"], b["w"], rtol=1e-5,
                                      atol=1e-7))
                for r in runs:
                    want = {n: expect.get(n, 0) for n in r["launches"]}
                    check(r["launches"] == want,
                          f"{name} {coll}: launches {r['launches']}, "
                          f"want {want}")
                    cx.add_counts(r["launches"])
                ls[f"{name}/{coll}"] = dict(
                    events=first["hist"]["averages"],
                    launches_per_rank=runs[0]["launches"],
                    step_ms=[r["step_ms"] for r in runs],
                    collectives_rank0=first["collectives"],
                    params_max_rel_err=rel, params_within_1e5=ok,
                    bitwise=coll == "gather")
            check(ls[f"{name}/psum"]["params_within_1e5"],
                  f"{name} psum: params beyond rtol 1e-5 / atol 1e-7 "
                  f"(max rel {ls[f'{name}/psum']['params_max_rel_err']})")
        # the mesh hands gloo the CUDA tensors; gloo stages them itself
        ls["gloo_cuda"] = "direct"
        ls["wall_s"] = time.perf_counter() - tp
        out["least_squares"] = ls

        # ---- (b) smollm-360m at full width over 2 ranks ------------------
        tp = time.perf_counter()
        lm_base = cx.lm_periodic
        cx.free()
        lm = spawn_ranks("lm", SHARD_LM_RANKS, td, timeout=900)
        got = torch.load(Path(td) / "lm-final.pt")
        want = lm_base["final"]
        check(len(got) == len(want), "smollm consensus leaves")
        worst, differ, total = 0.0, 0, 0
        for i, w in enumerate(want):
            g = got[i]
            d = (g.float() - w.float()).abs()
            # one bf16 ulp of each of phase 3's values: 2^(e - 8) for
            # |w| = m 2^e, m in [0.5, 1)
            e = torch.frexp(w.float())[1]
            ulp = torch.where(w == 0, torch.finfo(torch.bfloat16).tiny,
                              torch.ldexp(torch.ones_like(d), e - 8))
            worst = max(worst, float((d / ulp).max()))
            differ += int((d > 0).sum())
            total += d.numel()
        # measured bitwise on the H100 (the rows' update is opt_step.cu
        # on each rank, and the psum mean, rounded to bf16, lands on the
        # kernel's): held so
        check(differ == 0, f"smollm psum: consensus {differ} of {total} "
              f"elements off phase 3's (up to {worst} bf16 ulps)")
        h0 = lm[0]["hist"]
        check(all(r["hist"] == h0 for r in lm), "smollm: the ranks differ")
        check([v for _, v in h0["loss"]]
              == [v for _, v in lm_base["hist"]["loss"]],
              "smollm psum: losses differ from phase 3's")
        check(h0["averages"] == lm_base["hist"]["averages"]
              and [t for t, _ in h0["dispersion"]]
              == [t for t, _ in lm_base["hist"]["dispersion"]],
              "smollm psum: decisions differ from phase 3's run")
        for r in lm:
            want_l = {n: (lm_base["steps"] if n == "opt_step" else 0)
                      for n in r["launches"]}
            check(r["launches"] == want_l,
                  f"smollm psum: launches {r['launches']}, want {want_l}")
            cx.add_counts(r["launches"])
        loss_rel = float(np.max(np.abs(
            np.array([v for _, v in h0["loss"]])
            - np.array([v for _, v in lm_base["hist"]["loss"]]))
            / np.abs(np.array([v for _, v in lm_base["hist"]["loss"]]))))
        out["smollm_360m"] = dict(
            ranks=SHARD_LM_RANKS, workers=4, collective="psum",
            steps=lm_base["steps"], events=h0["averages"],
            unsharded_step_ms=lm_base["step_ms"],
            per_rank=[{k: r[k] for k in ("rows", "peak_gb", "step_ms",
                                         "wall_s", "collectives",
                                         "col_sum_ms", "sq_dist_ms",
                                         "broadcast_ms", "encode_row_ms",
                                         "launches")} for r in lm],
            gloo_cuda="direct",
            consensus_vs_phase3=dict(max_bf16_ulps=worst,
                                     elements_differing=differ,
                                     elements=total),
            loss_max_rel_err=loss_rel, wall_s=time.perf_counter() - tp)
        del got

        # ---- (c) the CLI under torchrun, one NCCL rank ---------------------
        tp = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        argv = ["--arch", "smollm-360m", "--reduced", "--steps", "6",
                "--workers", "4", "--avg", "periodic", "--phase-len", "2",
                "--device", "cuda"]
        cli = {}
        for tag, pre, extra in (
                ("plain", [sys.executable, "-m"], []),
                ("gather", [sys.executable, "-m", "torch.distributed.run",
                            "--standalone", "--nproc-per-node", "1", "-m"],
                 ["--shard", "--collective", "gather"])):
            t = time.perf_counter()
            r = subprocess.run(pre + ["repro_torch.launch.train"] + argv
                               + extra + ["--checkpoint", f"{td}/{tag}"],
                               env=env, capture_output=True, text=True,
                               timeout=400)
            check(r.returncode == 0, f"CLI {tag}: {r.stdout}\n{r.stderr}")
            lines = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("[train]")]
            cli[tag] = dict(lines=lines, wall_s=time.perf_counter() - t)
        shard_line = next(ln for ln in cli["gather"]["lines"]
                          if "sharding" in ln)
        check("backend=nccl" in shard_line and "over 1 devices" in shard_line,
              f"CLI --shard: {shard_line}")
        a = np.load(f"{td}/plain.state.npz")
        b = np.load(f"{td}/gather.state.npz")
        check(a.files == b.files and all(np.array_equal(a[k], b[k])
                                         for k in a.files),
              "CLI --shard --collective gather (NCCL): not bitwise the "
              "unsharded CLI run")
        ops = [next(ln for ln in cli[t]["lines"] if "averaging ops" in ln)
               .split("), ")[-1] for t in ("plain", "gather")]
        check(ops[0] == ops[1], f"CLI averaging ops {ops}")
        cli["gather_bitwise_plain"] = True
        cli["wall_s"] = time.perf_counter() - tp
        out["cli_torchrun_nccl"] = cli
    out["wall_s"] = time.perf_counter() - t_ph
    return out


# ---- phases 6, 12 and 13: serving at full width -------------------------
#: phase 12's serving runs, the decoder-only zoo (bf16, random weights):
#: the layers kept (None: the published depth; the MoE archs do not fit
#: whole, 84 GB and 800 GB of bf16 weights, so their depth is cut and
#: their widths kept), batch, prompt, tokens generated and each serve
#: prefill's kernel launches; starcoder2-3b's prompt runs past its 4096
#: window, gemma3-27b's past its 1024 one
ZOO_SERVE = {
    "starcoder2-3b": dict(layers=None, batch=4, prompt=5120, gen=32,
                          launches={"flash_attention": 30}),
    "minitron-8b": dict(layers=None, batch=4, prompt=2048, gen=32,
                        launches={"flash_attention": 32}),
    "gemma3-27b": dict(layers=None, batch=2, prompt=2048, gen=32,
                       launches={"flash_attention": 62}),
    "phi3.5-moe-42b-a6.6b": dict(layers=4, batch=4, prompt=2048, gen=16,
                                 launches={"flash_attention": 4}),
    "llama4-maverick-400b-a17b": dict(layers=2, batch=1, prompt=2048, gen=8,
                                      launches={"flash_attention": 2})}
#: phase 12's MoE training run: phi3.5-moe at its published widths cut to
#: ZOO_TRAIN_LAYERS layer (P = 1.56e9), through the training CLI's
#: ``setup`` as phase 3 runs smollm-360m: bf16, 2 workers, Momentum,
#: periodic K=2, 4 steps
ZOO_TRAIN_LAYERS = 1
ZOO_TRAIN_ARGV = ["--arch", "phi3.5-moe-42b-a6.6b", "--workers", "2",
                  "--batch", "4", "--seq", "64", "--optimizer", "momentum",
                  "--lr", "0.01", "--device", "cuda", "--steps", "4",
                  "--avg", "periodic", "--phase-len", "2"]


def cut_depth(cfg, layers):
    """``cfg`` with its first ``layers`` layers (None: unchanged)."""
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers,
                               layers=cfg.layers[:layers])


def serve_run(cx, cfg, run) -> dict:
    """One arch served as ``launch/serve.py`` serves it: ``init_params``
    (the reference's keys, drawn on the card) timed, the batch's frames
    for an audio or vlm arch (``serve.frames``), a warm-up prefill,
    then the timed prefill and decode, each launch count held against
    ``run["launches"]`` (decode launches none), the peak memory; the
    plain path on the card (einsum attention, the associative scan),
    its last logits and tokens against the kernel path's (reported, not
    gated: random-init logits over the vocabulary sit close together);
    where ``run`` has ``step_launches``, the cacheless prefill step too."""
    import torch

    from repro_torch.launch import serve, steps
    from repro_torch.models import init_params
    dev, name = cx.dev, cfg.name
    batch, plen, gen = run["batch"], run["prompt"], run["gen"]
    cx.free()
    # what earlier phases still hold: counted in the peak below
    resident_gb = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    cx.sync()
    t_init = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab_size, (batch, plen),
                           generator=torch.Generator().manual_seed(1)
                           ).to(dev)
    extra = serve.frames(cfg, batch, 1, dev)
    # warm-up prefill (cuBLAS set-up, the kernels' first launches)
    serve.prefill(cfg, params, prompt, max_len=gen, batch_extra=extra)
    cx.free()
    torch.cuda.reset_peak_memory_stats(dev)
    cx.zero_counts()
    t0 = time.perf_counter()
    logits, cache = serve.prefill(cfg, params, prompt, max_len=gen,
                                  batch_extra=extra)
    cx.sync()
    t_pre = time.perf_counter() - t0
    pre = cx.read_counts(run["launches"], f"serve {name} prefill")
    cx.zero_counts()
    t0 = time.perf_counter()
    toks = serve.decode(cfg, params, logits, cache, max_len=gen)
    cx.sync()
    t_dec = time.perf_counter() - t0
    dec = cx.read_counts({}, f"serve {name} decode")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(tuple(toks.shape) == (batch, gen), f"{name}: tokens "
          f"{tuple(toks.shape)}")
    check(0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size,
          f"{name}: a token beyond the vocabulary")
    check(bool(torch.isfinite(logits).all()), f"{name}: logits")
    del cache
    cx.free()
    cx.zero_counts()
    plogits, pcache = serve.prefill(cfg, params, prompt, max_len=gen,
                                    impl="plain", batch_extra=extra)
    ptoks = serve.decode(cfg, params, plogits, pcache, max_len=gen)
    cx.read_counts({}, f"serve {name} plain")
    del pcache
    cx.free()
    out = {}
    if "step_launches" in run:
        # the cacheless prefill step, the path of the arch's kernel,
        # after a warm-up; its last logits against the serve prefill's
        # (kernel against the chunked path; reported)
        step = steps.make_prefill_step(cfg)
        step(params, {"tokens": prompt, **extra})
        cx.free()
        torch.cuda.reset_peak_memory_stats(dev)
        cx.zero_counts()
        t0 = time.perf_counter()
        last = step(params, {"tokens": prompt, **extra})
        cx.sync()
        t_step = time.perf_counter() - t0
        got = cx.read_counts(run["step_launches"], f"{name} prefill step")
        step_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        check(tuple(last.shape) == (batch, cfg.padded_vocab)
              and bool(torch.isfinite(last).all()),
              f"{name}: prefill step logits")
        out = dict(
            prefill_step_ms=t_step * 1e3, launches_prefill_step=got,
            prefill_step_peak_memory_gb=step_peak_gb,
            prefill_step_vs_serve_last_logits_max_abs_diff=float(
                (last - logits[:, -1]).abs().max()),
            prefill_step_vs_serve_equal_argmax=float(
                (last.argmax(-1) == logits[:, -1].argmax(-1))
                .float().mean()))
        del last
        cx.free()
    if run["launches"]:
        # kernel against plain; where the serve prefill launches no
        # kernel (rwkv6-7b) both runs take the same path: left out
        out.update(
            kernel_vs_plain_last_logits_max_abs_diff=float(
                (logits - plogits).abs().max()),
            kernel_vs_plain_equal_tokens=float(
                (toks == ptoks).float().mean()))
    result = dict(
        batch=batch, prompt=plen, gen=gen, params=cfg.num_params(),
        init_params_s=t_init, prefill_ms=t_pre * 1e3,
        decode_ms_per_token=t_dec * 1e3 / gen,
        prefill_tokens_per_s=batch * plen / t_pre,
        decode_tokens_per_s=batch * gen / t_dec,
        end_to_end_tokens_per_s=batch * gen / (t_pre + t_dec),
        launches_prefill=pre, launches_decode=dec, peak_memory_gb=peak_gb,
        resident_before_gb=resident_gb,
        tokens_first_row=toks[0, :12].tolist(), **out)
    del params, prompt, extra, logits, plogits, toks, ptoks
    cx.free()
    return result


def zoo_train_run(cx) -> tuple:
    """phase 12's MoE training run: ``train.setup`` on ZOO_TRAIN_ARGV (its
    config cut to ZOO_TRAIN_LAYERS), then ``PhaseEngine.run``, the loss
    every step; ``opt_step`` once a step, ``avg_disp`` once an event.
    Returns (the final state's plane, copied to the host: a second run
    needs the card's memory, the run's report)."""
    import torch

    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats(cx.dev)
    full_config = train.get_config
    train.get_config = lambda arch, reduced=False: cut_depth(
        full_config(arch, reduced=reduced), ZOO_TRAIN_LAYERS)
    try:
        ap = train.make_parser()
        args = ap.parse_args(ZOO_TRAIN_ARGV)
        t0 = time.perf_counter()
        cfg, engine, params, batches = train.setup(args, ap)
        cx.sync()
        setup_s = time.perf_counter() - t0
    finally:
        train.get_config = full_config
    check(cfg.num_layers == ZOO_TRAIN_LAYERS
          and cfg.layers[0].ffn == "moe", f"MoE training config {cfg}")
    cx.zero_counts()
    t0 = time.perf_counter()
    final, hist, state = engine.run(
        params, batches(), num_workers=args.workers, seed=args.seed,
        record_every=1, phase_len=args.phase_len, return_state=True)
    cx.sync()
    wall = time.perf_counter() - t0
    events = args.steps // args.phase_len
    got = cx.read_counts({"opt_step": args.steps, "avg_disp": events},
                         "MoE training")
    losses = [v for _, v in hist["loss"]]
    check(len(losses) == args.steps and all(map(math.isfinite, losses)),
          f"MoE training: losses {losses}")
    check(hist["averages"] == events,
          f"MoE training: {hist['averages']} averaging ops, want {events}")
    plane = state.plane
    # every leaf: num_params and the final norm (a bias with layernorm)
    final_norm = (2 if cfg.norm == "layernorm" else 1) * cfg.d_model
    check(tuple(plane.shape) == (args.workers,
                                 cfg.num_params() + final_norm),
          f"MoE training: plane {tuple(plane.shape)}")
    check(bool(torch.isfinite(plane).all()), "MoE training: plane")
    report = dict(
        params=cfg.num_params(), active_params=cfg.num_active_params(),
        plane=list(plane.shape), setup_s=setup_s, wall_s=wall,
        step_ms=steady_step_ms(hist["phase_wall"]), losses=losses,
        averages=hist["averages"], launches=got,
        peak_memory_gb=torch.cuda.max_memory_allocated(cx.dev) / 1e9)
    plane = plane.cpu()
    del final, engine, params, state
    return plane, report


def phase_zoo(cx) -> dict:
    """phase 12: ZOO_SERVE's archs served (``serve_run``), the serve CLI
    once for starcoder2-3b (``--batch 1 --gen 4``), then the MoE training
    run twice, bitwise equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t_zoo = time.perf_counter()
    served = {}
    for arch, run in ZOO_SERVE.items():
        cfg = cut_depth(get_config(arch), run["layers"])
        t0 = time.perf_counter()
        served[arch] = dict(serve_run(cx, cfg, run), layers=cfg.num_layers,
                            published_layers=get_config(arch).num_layers,
                            active_params=cfg.num_active_params(),
                            wall_s=time.perf_counter() - t0)
    cx.zero_counts()
    t0 = time.perf_counter()
    cli_toks = serve.main(["--arch", "starcoder2-3b", "--batch", "1",
                           "--gen", "4"])
    cli_s = time.perf_counter() - t0
    cx.read_counts(ZOO_SERVE["starcoder2-3b"]["launches"],
                   "serve CLI starcoder2")
    check(tuple(cli_toks.shape) == (1, 4), "serve CLI starcoder2 tokens")
    cx.free()
    plane, first = zoo_train_run(cx)
    cx.free()
    plane2, second = zoo_train_run(cx)
    check(torch.equal(plane, plane2) and first["losses"] == second["losses"],
          "MoE training: two runs differ")
    del plane, plane2
    cx.free()
    return {"phase": "zoo", "serve": served,
            "serve_cli": {"arch": "starcoder2-3b", "batch": 1, "gen": 4,
                          "wall_s": cli_s},
            "moe_train": dict(first, second_wall_s=second["wall_s"],
                              second_step_ms=second["step_ms"],
                              bitwise=True),
            "reduced": ["phi3.5-moe-42b-a6.6b served at 4 of 32 layers, "
                        "trained at 1", "llama4-maverick-400b-a17b served "
                        "at 2 of 48 layers"],
            "wall_s": time.perf_counter() - t_zoo}


# ---- phase 13: encoders and cross-attention --------------------------------
#: phase 13's serving runs (bf16, random weights): the layers kept, batch,
#: prompt, tokens generated and each serve prefill's kernel launches.
#: whisper-small whole: 12 unmasked encoder layers and 12 causal decoder
#: layers launch flash_attention, its cross-attention takes the einsum
#: path; 384 + 64 tokens are its 448 published text positions.
#: llama-3.2-vision-90b at its published widths cut to two periods of its
#: 4 self : 1 cross-only pattern (whole it needs 175 GB of bf16 weights):
#: 8 self-attention layers
ENCDEC_SERVE = {
    "whisper-small": dict(layers=None, batch=16, prompt=384, gen=64,
                          launches={"flash_attention": 24}),
    "llama-3.2-vision-90b": dict(layers=10, batch=2, prompt=2048, gen=16,
                                 launches={"flash_attention": 8})}


def phase_encdec(cx) -> dict:
    """phase 13: ENCDEC_SERVE's archs served (``serve_run``, with the
    frames in the batch), then the serve CLI once for whisper-small
    (``--batch 2 --gen 4``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t_ph = time.perf_counter()
    served = {}
    for arch, run in ENCDEC_SERVE.items():
        cfg = cut_depth(get_config(arch), run["layers"])
        t0 = time.perf_counter()
        served[arch] = dict(
            serve_run(cx, cfg, run), layers=cfg.num_layers,
            published_layers=get_config(arch).num_layers,
            encoder_layers=cfg.encoder_layers,
            cross_layers=sum(s.cross_attn for s in cfg.layers),
            memory_tokens=cfg.encoder_seq or cfg.num_media_tokens,
            wall_s=time.perf_counter() - t0)
    cx.zero_counts()
    t0 = time.perf_counter()
    cli_toks = serve.main(["--arch", "whisper-small", "--batch", "2",
                           "--gen", "4"])
    cli_s = time.perf_counter() - t0
    cx.read_counts(ENCDEC_SERVE["whisper-small"]["launches"],
                   "serve CLI whisper-small")
    check(tuple(cli_toks.shape) == (2, 4), "serve CLI whisper tokens")
    cx.free()
    return {"phase": "encdec", "serve": served,
            "serve_cli": {"arch": "whisper-small", "batch": 2, "gen": 4,
                          "wall_s": cli_s},
            "reduced": ["llama-3.2-vision-90b served at 10 of 100 layers "
                        "(two periods of 4 self : 1 cross-only), published "
                        "widths"],
            "wall_s": time.perf_counter() - t_ph}


# ---- phase 14: the tree and unfused carries, steps, banded ----------------
#: phase 14's budget on a normal host (s), printed before its first call
TREE_BUDGET_S = 45.0
#: the card tolerance of the flat and tree carries against the flat-native
#: run, and of the phase step against two train steps and the average,
#: stated before the first chip run: one bf16 ulp of each value (the CPU
#: runs are bitwise; opt_step.cu and the event kernels match their plain
#: versions bitwise on the card, so bitwise is expected there too, and the
#: worst element is reported); losses rtol 1e-4
CARRY_TOL = dict(rtol=2 ** -8, atol=1e-6)
CARRY_LOSS_RTOL = 1e-4
#: (b)'s longer sequence, where the activations a remat recomputes show in
#: the peak: batch 4 x 1024 tokens a row, one step
REMAT_SEQ = 1024
#: (c): recurrentgemma-2b's cacheless prefill, banded against masked, at
#: phase 6's serving shape (4 x 3072 over its 2048 window) and a
#: long-document prompt of four windows; the last position's logits held
#: within BANDED_LOGIT_ATOL (stated before the first run: five times the
#: 0.10 that phase 6 measured between the kernel and plain prefills)
BANDED_SHAPES = ((4, 3072), (1, 8192))
BANDED_LOGIT_ATOL = 0.5


def hold_close(what: str, got, want, dev) -> dict:
    """``got`` against ``want`` (lists of tensors), leaf by leaf on
    ``dev``: every element within CARRY_TOL (an ``allclose``), else the
    check fails. Returns the largest |got - want|, the value it sits at,
    and whether every leaf is bitwise equal."""
    import torch
    worst, at, bitwise, bad = 0.0, 0.0, True, 0
    for g, w in zip(got, want):
        g, w = g.to(dev), w.to(dev)
        bitwise = bitwise and g.dtype == w.dtype and torch.equal(g, w)
        gf, wf = g.float(), w.float()
        d = (gf - wf).abs()
        bad += int((d > CARRY_TOL["atol"]
                    + CARRY_TOL["rtol"] * wf.abs()).sum())
        if d.numel() and float(d.max()) > worst:
            i = int(torch.argmax(d))
            worst, at = float(d.reshape(-1)[i]), float(wf.reshape(-1)[i])
        del g, w, gf, wf, d
    check(bad == 0, f"{what}: {bad} elements outside {CARRY_TOL} (worst "
          f"|diff| {worst} at {at})")
    return dict(max_abs=worst, at_value=at, bitwise=bitwise)


def phase_tree(cx) -> dict:
    """phase 14: (a) the CLI's ``--tree-engine`` and ``--no-fused-opt``
    carries at full width against phase 3's flat-native runs of the same
    argv; (b) ``steps.make_phase_step`` (flat-native: opt_step x 2,
    avg_disp x 1) with remat on and off, against two
    ``make_train_step`` steps and the average, and both peaks at
    REMAT_SEQ; (c) recurrentgemma-2b's banded prefill against the
    masked one at BANDED_SHAPES."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import average_all, replicate
    from repro_torch.core.flat import tree_flatten, tree_map
    from repro_torch.data import token_stream
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    print(f"[phase 14] tree, steps and banded: budget {TREE_BUDGET_S:.0f} s "
          "on a normal host", flush=True)
    t_ph = time.perf_counter()
    out = {"phase": "tree_steps_banded", "budget_s": TREE_BUDGET_S,
           "carry_tol": CARRY_TOL,
           # phase 3's runs, the baselines of (a), follow fewer
           # torch.profiler sessions: the launch cost at both
           "host_launch_us": dict(getattr(cx, "launch_us", {}),
                                  phase_14=host_launch_us(cx.dev))}

    # ---- (a) the carries through the CLI -------------------------------------
    t0 = time.perf_counter()
    pl2 = ["--avg", "periodic", "--phase-len", "2"]
    carries = {}
    for name, extra, base, expect in (
            ("tree", ["--tree-engine"] + pl2, cx.lm_periodic, {}),
            ("flat", ["--no-fused-opt"] + pl2, cx.lm_periodic,
             {"avg_disp": 2}),
            ("tree-ring-one_bit", ["--tree-engine"] + pl2 + [
                "--topology", "ring", "--comm-dtype", "one_bit"],
             cx.lm_one_bit, {"compressed_mix": 2})):
        steps_n = base["steps"]
        final, hist, state, wall = cx.train_run(
            cx.common + ["--steps", str(steps_n)] + extra, None)
        got = cx.read_counts(expect, f"carry {name}")
        check(hist["averages"] == base["hist"]["averages"] == 2
              and [t for t, _ in hist["dispersion"]]
              == [t for t, _ in base["hist"]["dispersion"]],
              f"carry {name}: decisions differ from the flat-native run")
        losses = [v for _, v in hist["loss"]]
        np.testing.assert_allclose(
            losses, [v for _, v in base["hist"]["loss"]],
            rtol=CARRY_LOSS_RTOL, err_msg=f"carry {name}: losses")
        diff = hold_close(f"carry {name}: final params",
                          tree_flatten(final)[0], base["final"], cx.dev)
        check(state.opt_state is None and state.params is None
              and tuple(state.plane.shape) == (FULL_M, FULL_P),
              f"carry {name}: the returned state is not in the plane "
              "layout")
        carries[name] = dict(
            steps=steps_n, averages=hist["averages"], launches=got,
            loss_first=losses[0], loss_last=losses[-1],
            losses_bitwise=losses == [v for _, v in base["hist"]["loss"]],
            params_vs_flat_native=diff,
            step_ms=steady_step_ms(hist["phase_wall"]),
            flat_native_step_ms=base["step_ms"], wall_s=wall,
            peak_memory_gb=torch.cuda.max_memory_allocated(cx.dev) / 1e9,
            idle_share="not measured (a torch.profiler trace at this "
                       "width is ~450 MB: phase 9)")
        del final, hist, state
        cx.free()
    out["carries"] = dict(carries, wall_s=time.perf_counter() - t0)

    # ---- (b) steps.make_phase_step at full width -----------------------------
    t0 = time.perf_counter()
    cfg = get_config("smollm-360m")
    params = init_params(cfg, 0, device=cx.dev)
    opt = steps.make_optimizer()

    def blocks(k, b, s):
        st = [token_stream(cfg.vocab_size, b, s, seed=i)
              for i in range(FULL_M)]
        return {"tokens": torch.from_numpy(np.stack([np.stack(
            [next(x) for x in st]) for _ in range(k)])).to(cx.dev)}

    def workers():
        wp = replicate(params, FULL_M)
        return wp, opt.init(wp)

    batches = blocks(2, 4, 64)
    res = {}
    for remat in (False, True):
        phase = steps.make_phase_step(cfg, phase_len=2, avg="all", flat=True,
                                      remat=remat)
        wp, os_ = workers()
        cx.zero_counts()
        cx.sync()
        t = time.perf_counter()
        wp, os_, losses = phase(wp, os_, batches, 0)
        cx.sync()
        ms = 1e3 * (time.perf_counter() - t)
        cx.read_counts({"opt_step": 2, "avg_disp": 1},
                       f"phase step remat={remat}")
        res[remat] = (tree_flatten(wp)[0], tree_flatten(os_)[0],
                      losses.tolist(), ms)
        del wp, os_
        cx.free()
    check(all(torch.equal(a, b) for a, b in zip(res[False][0], res[True][0]))
          and all(torch.equal(a, b) for a, b in zip(res[False][1],
                                                    res[True][1]))
          and res[False][2] == res[True][2],
          "phase step: remat on and off differ")
    train = steps.make_train_step(cfg, remat=False)
    wp, os_ = workers()
    cx.zero_counts()
    t = time.perf_counter()
    tl = []
    for k in range(2):
        wp, os_, loss = train(wp, os_, tree_map(lambda x: x[k], batches),
                              k + 1)
        tl.append(float(loss))
    wp = average_all(wp)
    cx.sync()
    train_ms = 1e3 * (time.perf_counter() - t)
    cx.read_counts({}, "train steps")
    np.testing.assert_allclose(tl, res[True][2], rtol=CARRY_LOSS_RTOL)
    vs_train = hold_close("phase step vs train steps",
                          res[True][0] + res[True][1],
                          tree_flatten(wp)[0] + tree_flatten(os_)[0],
                          cx.dev)
    phase_ms = {"remat_off": res[False][3], "remat_on": res[True][3]}
    del wp, os_, res
    cx.free()
    peaks = {}
    # the allocator's growth while the call's batch, worker params and
    # optimizer state are built: phase 15 (b) holds the counted argument
    # bytes against it. Earlier steps leave reference cycles holding
    # planes, which a collection inside the window would free: collect
    # first, and none in the window
    gc.collect()
    gc.disable()
    alloc0 = torch.cuda.memory_allocated(cx.dev)
    long_batch = blocks(1, 4, REMAT_SEQ)
    arg_growth = None
    for remat in (False, True):
        phase = steps.make_phase_step(cfg, phase_len=1, avg="all",
                                      flat=True, remat=remat)
        wp, os_ = workers()
        if arg_growth is None:
            arg_growth = torch.cuda.memory_allocated(cx.dev) - alloc0
            gc.enable()
        cx.free()
        torch.cuda.reset_peak_memory_stats(cx.dev)
        base_gb = torch.cuda.memory_allocated(cx.dev) / 1e9
        cx.zero_counts()
        t = time.perf_counter()
        wp, os_, losses = phase(wp, os_, long_batch, 0)
        cx.sync()
        cx.read_counts({"opt_step": 1, "avg_disp": 1},
                       f"long phase step remat={remat}")
        peaks[remat] = dict(peak_gb=torch.cuda.max_memory_allocated(cx.dev)
                            / 1e9, resident_before_gb=base_gb,
                            ms=1e3 * (time.perf_counter() - t),
                            loss=float(losses[0]))
        del wp, os_
        cx.free()
    check(peaks[False]["loss"] == peaks[True]["loss"],
          "long phase step: remat on and off losses differ")
    peaks[False]["argument_growth_bytes"] = arg_growth
    cx.long_step = dict(ms=peaks[False]["ms"], workers=FULL_M, batch=4,
                        seq=REMAT_SEQ, argument_growth_bytes=arg_growth)
    out["steps"] = dict(
        phase_len=2, workers=FULL_M, batch=4, seq=64,
        phase_ms=phase_ms,
        remat_bitwise=True, phase_vs_train_steps=vs_train,
        train_steps_plus_average_ms=train_ms,
        remat_peak=dict(seq=REMAT_SEQ, batch=4, off=peaks[False],
                        on=peaks[True]),
        wall_s=time.perf_counter() - t0)
    del params
    cx.free()

    # ---- (c) recurrentgemma-2b: banded against masked --------------------------
    t0 = time.perf_counter()
    rg = get_config("recurrentgemma-2b")
    rparams = init_params(rg, 0, device=cx.dev)
    banded = {}
    for b, s in BANDED_SHAPES:
        toks = torch.from_numpy(np.random.default_rng(s).integers(
            0, rg.vocab_size, (b, s))).to(cx.dev)
        row, logits = {}, {}
        for band in (False, True):
            step = steps.make_prefill_step(
                dataclasses.replace(rg, attn_banded=band), impl="plain")
            cx.zero_counts()
            with torch.no_grad():
                step(rparams, {"tokens": toks})  # warm-up
                cx.free()
                torch.cuda.reset_peak_memory_stats(cx.dev)
                t = time.perf_counter()
                # a copy: the step's last-position view would keep the
                # whole (B, S, V) logits alive into the next run
                logits[band] = step(rparams, {"tokens": toks}).float(
                ).clone()
                cx.sync()
            ms = 1e3 * (time.perf_counter() - t)
            cx.read_counts({}, f"plain prefill banded={band}")
            row["banded" if band else "masked"] = dict(
                ms=ms, peak_gb=torch.cuda.max_memory_allocated(cx.dev) / 1e9)
        w = rg.sliding_window
        c = min(w, s)
        d = float((logits[True] - logits[False]).abs().max())
        check(bool(torch.isfinite(logits[True]).all()) and
              d <= BANDED_LOGIT_ATOL,
              f"banded vs masked logits at {b} x {s}: max |diff| {d}")
        row.update(
            batch=b, seq=s, window=w,
            scores_per_head=dict(masked=s * s,
                                 banded=-(-s // c) * 2 * c * c,
                                 ratio=-(-s // c) * 2 * c * c / (s * s)),
            last_logits_max_abs_diff=d,
            equal_argmax=float((logits[True].argmax(-1)
                                == logits[False].argmax(-1)).float().mean()),
            banded_over_masked_ms=row["banded"]["ms"] / row["masked"]["ms"])
        banded[f"{b}x{s}"] = row
        del logits
        cx.free()
    del rparams
    cx.free()
    out["banded"] = dict(banded, arch="recurrentgemma-2b", impl="plain",
                         logit_atol=BANDED_LOGIT_ATOL,
                         wall_s=time.perf_counter() - t0)
    out["wall_s"] = time.perf_counter() - t_ph
    return out


# ---- phase 0: the port's static pass ----------------------------------------
#: phase 0's budget (s), printed before it runs: the pass takes about 4 s
#: on a 2-core CPU sandbox
STATIC_BUDGET_S = 10.0


def phase_static() -> dict:
    """phase 0: ``python -m repro_torch.analysis --format json`` in a
    subprocess from the script's root (exit 0, ``"ok": true``), then the
    kernels its ``kernel-twin`` rule discovers, read in this process
    (the pass imports only the standard library)."""
    import os
    from collections import Counter

    from repro_torch.analysis import RepoModel
    from repro_torch.analysis.rules.kernel_twin import discover_kernels

    print(f"[phase 0] static analysis: budget {STATIC_BUDGET_S:.0f} s",
          flush=True)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--format", "json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0,
          f"static analysis exited {proc.returncode}: "
          f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    report = json.loads(proc.stdout)
    check(report["ok"] is True and not report["stale_baseline"],
          f"static analysis not ok: {report['counts']}")
    kernels = sorted(n for _, n, _ in discover_kernels(RepoModel.load(ROOT)))
    return {"phase": "static_analysis", "budget_s": STATIC_BUDGET_S,
            "rules": report["rules"], "counts": report["counts"],
            "baseline_by_rule": dict(sorted(Counter(
                f["rule"] for f in report["accepted"]).items())),
            "kernels": kernels, "wall_s": time.perf_counter() - t0}


# ---- phase 15: the dry run, the roofline and the examples ------------------
#: phase 15's budget on a normal host (s), printed before its first call
DRYRUN_BUDGET_S = 40.0
#: (a)'s steps a schedule: the example's STEPS (60) cut to 20 before the
#: first chip run, as its CPU twin alone would pass the budget (37 s for
#: 60 steps at one thread on a 2-core sandbox)
QUICKSTART_STEPS = 20
#: (a): the final eval losses on the card against the CPU (f32
#: throughout, TF32 off). Stated from the first chip runs, which read them
#: equal (relative difference 0.0 for all three schedules, two calls);
#: 1e-5 leaves room for another cuBLAS summation order
QUICKSTART_EVAL_RTOL = 1e-5
#: (b): the counted bound may not exceed the measured time by more than
#: this share (a bound the card beats means the count is wrong), and the
#: counted argument bytes must be within this share of the allocator's
#: growth. The first chip run read the growth 0.58% above the count: a
#: block carved from a cached segment takes the remainder when under
#: 1 MB is left, so memory_allocated runs above the tensors' bytes
BOUND_SHARE_MAX = 1.05
ARG_BYTES_RTOL = 0.01
#: (c): the dry-run row the card's machine writes
DRYRUN_ARGV = ["--arch", "smollm-360m", "--shape", "train_4k", "--mesh",
               "single"]
DRYRUN_ROW_KEYS = ("arch", "shape", "mesh", "avg", "chips", "phase_steps",
                   "count_s", "model_flops", "variant", "collectives",
                   "flops_per_device", "bytes_per_device",
                   "collective_bytes_per_device", "compute_s", "memory_s",
                   "collective_s", "bottleneck", "step_time_lower_bound_s",
                   "useful_flop_fraction", "mem_argument_size_in_bytes",
                   "mem_output_size_in_bytes")


def phase_dryrun(cx) -> dict:
    """phase 15: (a) ``examples/quickstart_torch.py`` on the card, then on
    the CPU (QUICKSTART_STEPS a schedule): the same averages, the
    launches (``opt_step`` a step, ``avg_disp`` a periodic event), the
    eval losses within QUICKSTART_EVAL_RTOL; (b) phase 14 (b)'s long
    phase step counted on ``meta`` (``roofline.count_step``) against the
    time phase 14 measured for it: its bound's share of that time within
    BOUND_SHARE_MAX, its mfu, and its counted argument bytes against the
    allocator's growth; (c) one row of ``repro_torch.launch.dryrun`` in a
    subprocess (one thread), started first and read last: it runs beside
    (a) and (b) on the host's other cores."""
    import importlib.util
    import os
    import tempfile

    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.roofline import (HW, count_step, model_flops,
                                      roofline_report)
    print(f"[phase 15] dry run, roofline and examples: budget "
          f"{DRYRUN_BUDGET_S:.0f} s on a normal host", flush=True)
    t_ph = time.perf_counter()
    out = {"phase": "dryrun_roofline_examples", "budget_s": DRYRUN_BUDGET_S}

    # ---- (c) started first, read last: the dry run needs no card ----------
    tmp = tempfile.TemporaryDirectory()
    rows_path = Path(tmp.name) / "rows.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t_c = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGV,
         "--out", str(rows_path)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # ---- (a) the quickstart on the card, then on the CPU -----------------
        t0 = time.perf_counter()
        spec = importlib.util.spec_from_file_location(
            "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
        qs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(qs)
        qs.STEPS = QUICKSTART_STEPS
        cx.zero_counts()
        tc = time.perf_counter()
        card = qs.main([])
        cx.sync()
        card_s = time.perf_counter() - tc
        got = cx.read_counts({"opt_step": 3 * QUICKSTART_STEPS,
                              "avg_disp": QUICKSTART_STEPS // 10},
                             "quickstart on the card")
        tc = time.perf_counter()
        cpu = qs.main(["--device", "cpu"])
        cpu_s = time.perf_counter() - tc
        rel = {}
        for name in card:
            check(card[name]["averages"] == cpu[name]["averages"],
                  f"quickstart {name}: averages {card[name]['averages']} on "
                  f"the card, {cpu[name]['averages']} on the CPU")
            a, b = card[name]["eval_loss"], cpu[name]["eval_loss"]
            rel[name] = abs(a - b) / abs(b)
        check(max(rel.values()) <= QUICKSTART_EVAL_RTOL,
              f"quickstart eval losses card vs CPU: {rel}")
        out["quickstart"] = dict(
            steps=QUICKSTART_STEPS, launches=got,
            averages={n: r["averages"] for n, r in card.items()},
            eval_loss_card={n: r["eval_loss"] for n, r in card.items()},
            eval_loss_cpu={n: r["eval_loss"] for n, r in cpu.items()},
            eval_loss_rel_diff=rel, eval_rtol=QUICKSTART_EVAL_RTOL,
            card_s=card_s, cpu_s=cpu_s, wall_s=time.perf_counter() - t0)
        cx.free()

        # ---- (b) phase 14 (b)'s long phase step, counted -------------------
        t0 = time.perf_counter()
        ls = cx.long_step
        cfg = get_config("smollm-360m")
        opt = steps.make_optimizer()
        wp, os_ = steps.abstract_worker_state(cfg, opt, ls["workers"])
        batch = {"tokens": steps.sds((1, ls["workers"], ls["batch"],
                                      ls["seq"]), torch.int32)}
        fn = steps.make_phase_step(cfg, phase_len=1, avg="all", flat=True,
                                   remat=False, kernel_impl="ref")
        counts = count_step(fn, wp, os_, batch, 0)
        mf = model_flops(cfg, ShapeConfig(
            "phase14b-long", "train", ls["seq"],
            ls["workers"] * ls["batch"]), training=True)
        rep = roofline_report(counts, model_flops=mf)
        measured_s = ls["ms"] / 1e3
        share = rep["step_time_lower_bound_s"] / measured_s
        mfu = mf / (measured_s * HW().peak_flops)
        arg = rep["mem_argument_size_in_bytes"]
        growth = ls["argument_growth_bytes"]
        print(f"[phase 15] counted flops {counts.flops:.6e} bytes "
              f"{counts.bytes:.6e} model_flops {mf:.6e}; bound "
              f"{rep['step_time_lower_bound_s'] * 1e3:.3f} ms "
              f"({rep['bottleneck']}), phase 14 (b) measured "
              f"{ls['ms']:.3f} ms: bound_share {share:.4f}, mfu {mfu:.4f}",
              flush=True)
        check(share <= BOUND_SHARE_MAX,
              f"roofline: the bound {rep['step_time_lower_bound_s']} s "
              f"exceeds the measured {measured_s} s (share {share})")
        check(abs(arg - growth) <= ARG_BYTES_RTOL * growth,
              f"roofline: counted argument bytes {arg} against the "
              f"allocator's growth {growth}")
        out["roofline"] = dict(
            step="phase 14 (b) long phase step: smollm-360m, M 4, B 4 x "
                 "1024, phase_len 1, remat off, flat-native",
            flops=counts.flops, bytes=counts.bytes, ops=counts.ops,
            model_flops=mf, bottleneck=rep["bottleneck"],
            compute_s=rep["compute_s"], memory_s=rep["memory_s"],
            step_time_lower_bound_s=rep["step_time_lower_bound_s"],
            measured_ms=ls["ms"], bound_share=share, mfu=mfu,
            useful_flop_fraction=rep["useful_flop_fraction"],
            mem_argument_size_in_bytes=arg, argument_growth_bytes=growth,
            argument_rel_diff=(arg - growth) / growth,
            mem_output_size_in_bytes=rep["mem_output_size_in_bytes"],
            count_s=counts.seconds, wall_s=time.perf_counter() - t0)

        # ---- (c) the dry-run row -------------------------------------------
        t0 = time.perf_counter()
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0,
          f"dryrun exited {proc.returncode}: {stderr[-2000:]}")
    rows = [json.loads(ln) for ln in rows_path.read_text().splitlines()]
    tmp.cleanup()
    check(len(rows) == 1 and all(k in rows[0] for k in DRYRUN_ROW_KEYS),
          f"dryrun row: {rows}")
    out["dryrun"] = dict(argv=DRYRUN_ARGV, row=rows[0],
                         torch=torch.__version__,
                         waited_s=time.perf_counter() - t0,
                         wall_s=time.perf_counter() - t_c)
    out["wall_s"] = time.perf_counter() - t_ph
    return out


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

    kernels = _kernel_wrappers()
    main_launches = dict.fromkeys(kernels, 0)

    def zero_counts():
        for k in kernels.values():
            k.launches = 0

    def add_counts(got: dict):
        for n, c in got.items():
            main_launches[n] += c

    def read_counts(expect: dict, what: str) -> dict:
        """The counts of the run just driven, held against ``expect``
        (kernels not named there must not have launched); added to the
        main path's totals."""
        got = {n: k.launches for n, k in kernels.items()}
        want = {n: expect.get(n, 0) for n in kernels}
        check(got == want, f"{what}: launches {got}, want {want}")
        add_counts(got)
        return got

    # ---- 0. the static pass, before any build ------------------------------
    static = phase_static()
    emit(static)

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
    for hd in cc.FLASH_NO_SPILL_HEAD_DIMS:
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
    # avg_disp.cu's 40 instantiations (MAXM 4..64 x columns a thread x
    # MASKED x CODES): registers and spills of each (key MAXM-V-MASKED-
    # CODES)
    ptx_avg = {r["kernel"]: r for r in info["ptxas"]["avg_disp"]}
    avg_regs = {key: {k: ptx_avg[n][k] for k in
                      ("registers", "spill_stores", "spill_loads")}
                for key, n in sorted(avg_disp_kernels(ptx_avg).items())}
    check(len(avg_regs) == AVG_DISP_INSTANTIATIONS,
          f"avg_disp_cols instantiations in ptxas: {sorted(avg_regs)}")
    # up to 32 workers (every plane the main path gives it) none spills
    for key, r in avg_regs.items():
        check(int(key.split("-")[0]) > 32
              or r["spill_stores"] == r["spill_loads"] == 0,
              f"avg_disp_cols<{key}> spills: {r}")
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "device": kind_name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "built": info["built"],
          "flash_fwd_wgmma_ptxas": flash_regs,
          "flash_fwd_wgmma_hgmma": hgmma,
          "rwkv6_chunk_mma_ptxas": wkv_regs,
          "rwkv6_chunk_mma_tf32_hmma": wkv_hmma,
          "avg_disp_cols_ptxas": avg_regs, "cuobjdump": tool,
          "ptxas": info.get("ptxas", {})})

    # ---- 2. kernels against their plain versions ---------------------------
    # the sweep and its criteria: repro_torch.kernels.card_check
    launch_us = {"before_phase_2": host_launch_us(dev)}
    t_phase = t0 = time.perf_counter()
    n_cases, err = cc.sweep(dev)
    # avg_disp.cu's one-launch design: column widths, ragged and narrow
    # planes, the CNN's, the persistent grid's span, the cached scratch
    n_avg, avg_res = cc.avg_sweep(dev)
    err["avg_disp"] = max(err["avg_disp"], avg_res["avg_disp"])
    sweep_s = time.perf_counter() - t0

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
    u = cc.wire_inputs(dev, FULL_M, FULL_P, seed=9)[1]
    time_compressed("int8-mean", x, r, u, None, wire="int8", mode="mean")
    del u, r
    free()

    def time_event(name, kname, check_fn, run_k, run_p, cost, lib=None,
                   split=False):
        """A full-width ``avg_disp`` / ``mix_disp`` call: checked, then
        timed beside its plain version (and ``lib``, one PyTorch call);
        ``split``: the kernel's time as :func:`call_split` splits it."""
        err[kname] = max(err[kname], check_fn())
        free()
        extra = {}
        if split:
            extra = call_split(run_k, 10, 5)
            k_ms = extra.pop("ms")
        else:
            k_ms = cuda_time(run_k, 10)
        free()
        p_ms = cuda_time(run_p, 3)
        free()
        lib_ms = None
        if lib is not None:
            lib_ms = cuda_time(lib, 10)
            free()
        record(name, k_ms, p_ms, cost, library_ms=lib_ms, **extra)

    # f32 means and group means, then the coded mean of the LM plane's
    # periodic event (bf16 codes); each held as one launch a call
    # (check_avg_event) and split into device and host
    for grp, cd in ((1, None), (2, None), (1, codes)):
        tag = f"g{grp}" + ("-codes" if cd is not None else "")
        time_event(f"avg_disp/{tag}", "avg_disp",
                   lambda: cc.check_avg_event(f"avg_disp/full-{tag}", x, grp,
                                              cd)[0],
                   lambda: avg_disp(x, groups=grp, codes=cd),
                   lambda: ref.plane_average_ref(x, groups=grp, codes=cd),
                   avg_disp_cost(FULL_M, FULL_P, cd is not None), split=True)
    # the ring mix, f32 and coded; one PyTorch call for the mix (not the
    # dispersion, nor the rounding): W @ x in full f32
    for cd in (None, codes):
        tag = "ring" + ("-codes" if cd is not None else "")
        time_event(f"mix_disp/{tag}", "mix_disp",
                   lambda: cc.check_mix_disp(f"mix_disp/full-{tag}", x, ring,
                                             cd),
                   lambda: mix_disp(x, ring, codes=cd),
                   lambda: ref.mix_disp_ref(x, ring, codes=cd),
                   mix_disp_cost(FULL_M, FULL_P, cd is not None),
                   lib=lambda: torch.matmul(ring, x))

    # the outer step, f32 and with the LM plane's bf16 codes (the CODES
    # instantiation: the coded outer event of the main path)
    gen = torch.Generator(device=dev).manual_seed(10)
    prev = torch.randn(FULL_P, device=dev, generator=gen)
    vel = torch.randn(FULL_P, device=dev, generator=gen) * 1e-2
    for cd in (None, codes):
        tag = "nesterov" + ("-codes" if cd is not None else "")
        pv = prev if cd is None else ref.round_to_codes(prev, cd)
        okw = dict(lr=1.0, momentum=0.5, nesterov=True, codes=cd)
        e = cc.check_avg_disp_outer(f"avg_disp_outer/full-{tag}", x, pv,
                                    vel, **okw)
        err["avg_disp_outer"] = max(err["avg_disp_outer"], e)
        free()
        k_ms = cuda_time(lambda: avg_disp_outer(x, pv, vel, **okw), 10)
        free()
        p_ms = cuda_time(lambda: ref.avg_disp_outer_ref(x, pv, vel, **okw),
                         3)
        free()
        record(f"avg_disp_outer/{tag}", k_ms, p_ms,
               avg_disp_outer_cost(FULL_M, FULL_P, cd is not None))
        del pv
    del x, prev, vel, codes
    free()
    # avg_disp at the §3.2 CNN's plane and the paper's least-squares
    # plane (24 x 1024: groups 1 and the hierarchical inner event's 4),
    # held and split as above; the CNN's traced once: one kernel a call,
    # no sum_partials
    small_planes = {}
    for name, (m_, p_, grp, trace) in AVG_SPLIT_PLANES.items():
        xl = cc.make_inputs(dev, m_, p_, "sgd", seed=9)[0]
        e, grid = cc.check_avg_event(f"avg_disp/{name}", xl, grp)
        err["avg_disp"] = max(err["avg_disp"], e)
        row = call_split(lambda: avg_disp(xl, groups=grp), 200, 50,
                         trace=trace)
        check(not trace or (row["kernels_per_call"] == 1 and not any(
            "sum_partials" in k for k in row["kernel_ms"])),
            f"avg_disp/{name}: {row.get('kernel_ms')} a call")
        b_ms, b_by = bound_ms(*avg_disp_cost(m_, p_))
        row["plain_ms"] = cuda_time(
            lambda: ref.plane_average_ref(xl, groups=grp), 50)
        small_planes[f"avg_disp/{name}"] = dict(
            M=m_, P=p_, grid=grid, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=e, **row)
        del xl

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
        k_dev_ms = device_ms(lambda: flash_attention(q, k, v, **fkw), 5)
        p_ms = cuda_time(lambda: ref.flash_attention_ref(q, k, v, **fkw), 2)
        free()
        lib_ms, backend, lib_err, lib_dev_ms = sdpa_time(q, k, v, cuda_time,
                                                         **fkw)
        free()
        b_, s_, h_, hkv_, hd_ = shape
        cost = attention_cost(b_, s_, h_, hkv_, hd_, causal, window)
        record(f"flash_attention/{arch}", k_ms, p_ms, cost,
               peak=BF16_FLOPS_PER_S, library_ms=lib_ms,
               library=f"scaled_dot_product_attention ({backend})",
               library_max_abs_diff=lib_err,
               pairs_per_head=band_pairs(s_, causal, window),
               tflops=cost[1] / k_ms / 1e9,
               library_tflops=cost[1] / lib_ms / 1e9,
               device_ms=k_dev_ms, library_device_ms=lib_dev_ms)
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
          "avg_sweep_cases": n_avg, "avg_disp_grids": avg_res["grids"],
          "serve_sweep_cases": n_serve, "sweep_s": sweep_s,
          "serve_sweep_s": serve_sweep_s, "max_abs_err": err,
          "serve_max_abs_err": serve_err,
          "flash_serve_tol": dict(zip(("atol", "rtol"), cc.FLASH_SERVE_TOL)),
          "rwkv6_tol": dict(zip(("atol", "rtol"), cc.RWKV6_TOL)),
          "full_width": {"M": FULL_M, "P": FULL_P, **full},
          "small_planes": small_planes,
          "wall_s": time.perf_counter() - t_phase, "card": smi})

    # ---- 3. the main path at full width (bf16 smollm-360m) ----------------
    from repro_torch.launch import train
    launch_us["phase_3"] = host_launch_us(dev)
    t_phase = time.perf_counter()

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
    runs, lm_kept = {}, {}
    # every way the engine could reach the outer step's plain version,
    # counted: the coded outer event must launch avg_disp_outer instead
    from repro_torch.core import engine as engine_mod
    from repro_torch.kernels import avg_disp as avg_mod
    plain_outer = {"calls": 0}

    def counted_outer_ref(*a, **k):
        plain_outer["calls"] += 1
        return ref.avg_disp_outer_ref(*a, **k)
    avg_mod.avg_disp_outer_ref = counted_outer_ref
    engine_mod._PLAIN_OPS["avg_disp_outer"] = counted_outer_ref
    for name, extra, phase_len, steps, events, expect in (
            ("periodic", ["--avg", "periodic", "--phase-len", "2"], None, 4,
             2, {"opt_step": 4, "avg_disp": 2}),
            ("periodic-ring", ["--avg", "periodic", "--phase-len", "2",
                               "--topology", "ring"], None, 4, 2,
             {"opt_step": 4, "mix_disp": 2}),
            ("minibatch", ["--avg", "minibatch"], 1, 2, 2, {"opt_step": 2}),
            ("minibatch-ring", ["--avg", "minibatch", "--topology", "ring"],
             1, 2, 2, {"opt_step": 2}),
            ("periodic-ring-one_bit",
             ["--avg", "periodic", "--phase-len", "2", "--topology", "ring",
              "--comm-dtype", "one_bit"], None, 4, 2,
             {"opt_step": 4, "compressed_mix": 2}),
            ("minibatch-bf16-wire", ["--avg", "minibatch", "--comm-dtype",
                                     "bf16"], 1, 2, 2,
             {"opt_step": 2, "compressed_mix": 2}),
            ("periodic-outer", ["--avg", "periodic", "--phase-len", "2",
                                "--outer-momentum", "0.5"], None, 4, 2,
             {"opt_step": 4, "avg_disp_outer": 2})):
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
        check((state.outer_state != ()) == ("--outer-momentum" in extra),
              f"{name}: outer state")
        if state.outer_state != ():
            prev = state.outer_state[0]
            check(torch.equal(prev, prev.to(torch.bfloat16).float())
                  and torch.equal(prev, plane[0]),
                  f"{name}: the outer average off the grid or not "
                  "broadcast")
        if name in ("periodic", "periodic-ring-one_bit"):
            # phase 11 (b) holds the sharded run against the periodic
            # one, phase 14 (a) the tree and flat carries against both
            lm_kept[name] = dict(
                final=[v.cpu() for v in
                       torch.utils._pytree.tree_leaves(final)],
                hist=hist, steps=steps,
                step_ms=steady_step_ms(hist["phase_wall"]))
        runs[name] = dict(steps=steps, averages=hist["averages"],
                          loss_first=losses[0], loss_last=losses[-1],
                          launches=got, step_ms=steady_step_ms(
                              hist["phase_wall"]),
                          wall_s=wall, resid_abs_max=resid_abs_max,
                          max_memory_gb=torch.cuda.max_memory_allocated(dev)
                          / 1e9)
        del final, hist, state, plane
        free()
    check(plain_outer["calls"] == 0,
          f"the plain avg_disp_outer_ref ran {plain_outer['calls']} times")
    avg_mod.avg_disp_outer_ref = ref.avg_disp_outer_ref
    engine_mod._PLAIN_OPS["avg_disp_outer"] = ref.avg_disp_outer_ref
    runs["periodic-outer"]["plain_outer_calls"] = plain_outer["calls"]
    lm_periodic = lm_kept["periodic"]
    emit({"phase": "main_path_bf16", "arch": "smollm-360m",
          "host_launch_us": launch_us,
          "params": FULL_P, "workers": FULL_M, **runs,
          "wall_s": time.perf_counter() - t_phase, "card": smi})

    # ---- 4. the f32 path: the paper's least squares ------------------------
    t_phase = time.perf_counter()
    from repro_torch.configs import get_config
    from repro_torch.configs.paper import CONVEX_SUITE
    from repro_torch.core import AveragingSchedule, PhaseEngine
    from repro_torch.core.averaging import OuterOptimizer
    from repro_torch.core.compress import Compression
    from repro_torch.data import DeviceDataset, convex_dataset, token_stream
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.convex import make_problem
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

    def convex_loss(kind):
        """A worker's loss on its batch (one sample or several): the §3.1
        objective of ``models.convex`` over those samples."""
        obj = make_problem(kind)[0]

        def loss(p, b, r):
            w = p["w"]
            return obj(w, b["x"].reshape(-1, w.shape[0]),
                       b["y"].reshape(-1)), {}
        return loss

    ls_objective = make_problem("ls")[0]

    def objective(w):
        return float(ls_objective(w.to(dev), Xd, yd))

    def convex_run(sched, steps, device, staged=False, **comm):
        """A run over a DeviceDataset of the (steps, M) draws, batches
        gathered on ``device``; ``staged``: over a generator of the same
        batches, gathered ahead and staged by the engine instead."""
        idx = np.random.default_rng(1).integers(0, c.num_samples,
                                                (steps, mw))
        Xs, ys = Xd.to(device), yd.to(device)
        if staged:
            data = ({"x": Xs[idx[t]], "y": ys[idx[t]]} for t in range(steps))
        else:
            data = DeviceDataset({"x": Xs, "y": ys}, mw, indices=idx,
                                 device=device)
        eng = PhaseEngine(convex_loss("ls"), opt, sched, device=device,
                          **comm)
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
    f32, kept = {}, {}
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
        if name == "hierarchical":
            kept[name] = (final, hist, state)
        del final, hist, state

    # the hierarchical run once more, fed by a generator of the same
    # batches (staged): bitwise its indexed twin
    final_g, hist_g, state_g = kept.pop("hierarchical")
    zero_counts()
    final_s, hist_s, state_s = convex_run(hier, 64, "cuda", staged=True)
    read_counts({"opt_step": 64, "avg_disp": 8}, "hierarchical staged")
    check(torch.equal(state_s.plane, state_g.plane)
          and torch.equal(final_s["w"], final_g["w"])
          and hist_s["loss"] == hist_g["loss"]
          and hist_s["dispersion"] == hist_g["dispersion"],
          "hierarchical: staged and indexed runs differ on the card")
    f32["hierarchical_staged"] = dict(
        steps=64, events=hist_s["averages"], bitwise_indexed=True,
        step_ms=steady_step_ms(hist_s["phase_wall"]))
    del final_s, hist_s, state_s, state_g

    # the same run on the CPU (the kernels' plain versions) as reference
    final_c, hist_c, _ = convex_run(hier, 64, "cpu")
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
          "wall_s": time.perf_counter() - t_phase, "card": smi})

    # ---- 5. the paper's §3.1 convex suite at full size ---------------------
    t_suite = time.perf_counter()
    suite = phase_convex_curves(SimpleNamespace(
        dev=dev, zero_counts=zero_counts, read_counts=read_counts,
        free=free, sync=lambda: torch.cuda.synchronize(dev)))

    # one config three ways over the same 256 steps: run over the
    # DeviceDataset (indexed), run over host numpy batches (staged by the
    # Prefetcher) and run_host; all three bitwise equal
    c = CONVEX_SUITE[1]
    X, y, _ = convex_dataset(c.model, c.num_samples, c.num_dims,
                             sparsity=c.sparsity, noise=c.noise, seed=0)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    idx = np.random.default_rng(0).integers(0, c.num_samples,
                                            (HOST_STEPS, c.num_workers))
    lr0 = SUITE_LR_MULT * SUITE_LR_D / float(np.mean(np.sum(X * X, axis=1)))
    eng = PhaseEngine(convex_loss(c.model),
                      SGD(lr=lambda t: lr0 / (t - 1.0 + SUITE_LR_D)),
                      AveragingSchedule("periodic", phase_len=128),
                      device="cuda")
    w0 = {"w": torch.zeros(c.num_dims, device=dev)}
    kw = dict(num_workers=c.num_workers, seed=0, record_every=SUITE_EVERY)
    three = {}
    expect = {"opt_step": HOST_STEPS, "avg_disp": HOST_STEPS // 128}
    for name in ("indexed", "staged", "run_host"):
        zero_counts()
        if name == "indexed":
            f, h = eng.run(w0, DeviceDataset({"x": Xd, "y": yd},
                                             c.num_workers, indices=idx,
                                             device="cuda"), **kw)
        elif name == "staged":
            f, h = eng.run(w0, ({"x": X[i], "y": y[i]} for i in idx), **kw)
        else:
            f, h = eng.run_host(w0, ({"x": X[i], "y": y[i]} for i in idx),
                                **kw)
        read_counts(expect, f"{c.name} {name}")
        # the steps after the first period (run's first phase, which
        # warms up); run_host's phase_wall holds one entry per step
        steady = [(t1_ - t0_ + 1, w) for t0_, t1_, w in h["phase_wall"]
                  if t0_ > 128]
        three[name] = dict(params=f["w"], hist=h, ms_per_step=1e3 * sum(
            w for _, w in steady) / sum(n for n, _ in steady))
    for name in ("staged", "run_host"):
        check(torch.equal(three[name]["params"], three["indexed"]["params"])
              and three[name]["hist"]["loss"] == three["indexed"]["hist"][
                  "loss"]
              and three[name]["hist"]["dispersion"] == three["indexed"][
                  "hist"]["dispersion"],
              f"{c.name}: {name} differs from the indexed run")
    host_vs_run = dict(config=c.name, schedule="periodic_128",
                       steps=HOST_STEPS, bitwise=True,
                       **{f"{k}_ms_per_step": v["ms_per_step"]
                          for k, v in three.items()})
    # where an indexed step's time goes: 32 warm steps, then 32 under
    # torch.profiler; idle share against the unprofiled indexed step
    from repro_torch.launch.profile import _breakdown, _profiler
    ds = DeviceDataset({"x": Xd, "y": yd}, c.num_workers, indices=idx[:64],
                       device="cuda")
    _, _, st = eng.run(w0, ds, num_workers=c.num_workers, steps=32,
                       return_state=True)
    torch.cuda.synchronize(dev)
    with _profiler() as prof:
        eng.run(None, ds, num_workers=c.num_workers, steps=32, state=st)
        torch.cuda.synchronize(dev)
    bd = _breakdown(prof, 32, three["indexed"]["ms_per_step"] * 1e3)
    host_vs_run["indexed_profile"] = {
        k: bd[k] for k in ("device_busy_ms", "idle_share",
                           "kernels_per_step", "by_group_ms")}
    del Xd, yd, three, st, ds
    free()
    emit({"phase": "convex_suite", "steps": SUITE_STEPS,
          "record_every": SUITE_EVERY, "lr_mult": SUITE_LR_MULT,
          "lr_d": SUITE_LR_D, "configs": suite,
          "through": ["repro_torch.experiments.fig2_convex.sgd_curves",
                      "repro_torch.experiments.table1.table1_row"],
          "indexed_staged_run_host": host_vs_run,
          "reduced": [f"{SUITE_STEPS} steps, not the paper's 3000",
                      "one point (0.8) of the reference's learning-rate "
                      "grid (0.4, 0.8, 1.6, 3.0, 6.0)",
                      "periodic at half and all of the steps, not 128 and "
                      "1024"],
          "wall_s": time.perf_counter() - t_suite, "card": smi})

    # ---- 6. serving at full width (bf16, random weights) ------------------
    from repro_torch.launch import serve
    cx = SimpleNamespace(
        dev=dev, zero_counts=zero_counts, read_counts=read_counts, free=free,
        cuda_time=cuda_time, sync=lambda: torch.cuda.synchronize(dev),
        common=common, workers=FULL_M, tele_steps=4, cnn_steps=CNN_STEPS,
        lemma_reps=LEMMA1_REPS)
    t_serve = time.perf_counter()
    served = {arch: serve_run(cx, get_config(arch), run)
              for arch, run in SERVE.items()}
    # the CLI on the card, once
    zero_counts()
    cli_toks = serve.main(["--arch", "smollm-360m", "--batch", "2",
                           "--prompt-len", "64", "--gen", "4"])
    read_counts({"flash_attention": 32}, "serve CLI")
    check(tuple(cli_toks.shape) == (2, 4), "serve CLI tokens")
    emit({"phase": "serve", **served,
          "wall_s": time.perf_counter() - t_serve, "card": smi})

    # ---- 7. faults ----------------------------------------------------------
    from repro_torch.faults import FaultPlan, degraded_matrix
    from repro_torch.launch.profile import _breakdown
    t_faults = time.perf_counter()
    t0 = time.perf_counter()
    n_fault, fault_err = cc.fault_sweep(dev)
    fault_sweep_s = time.perf_counter() - t0
    part_s = {}
    tp = time.perf_counter()
    # full width: one dead row, as the smollm run's crash leaves it
    dead1 = np.array([1, 0, 1, 1], np.float32)
    ff = {}

    def record_fault(name, k_ms, p_ms, cost, pr20_cost=None):
        b_ms, b_by = bound_ms(*cost)
        ff[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                        bytes=cost[0], flops=cost[1])
        if pr20_cost is not None:
            # the yardstick of the wrapped path this one replaced (the
            # wrapped kernels, the saved rows, the masked dispersion)
            ff[name]["pr20_bound_ms"] = bound_ms(*pr20_cost)[0]

    x, g, st, scal, codes = cc.make_inputs(dev, FULL_M, FULL_P, "momentum",
                                           "bf16", seed=17, scale=1e-3)
    for mode in ("none", "mean"):
        kw = dict(kind="momentum", mu=0.9, mode=mode)
        fault_err["opt_step"] = max(fault_err["opt_step"],
                                    cc.check_opt_step_fault(
                                        f"opt_step/full-fault-{mode}", x, g,
                                        st, scal, codes, dead1, dead1, **kw))
        free()
        xk, sk = x.clone(), tuple(s_.clone() for s_ in st)
        k_ms = cuda_time(lambda: opt_step(xk, g, sk, scal, codes=codes,
                                          alive=dead1, **kw), 5)
        del xk, sk
        free()
        p_ms = cuda_time(lambda: ref.opt_step_ref(x, g, st, scal,
                                                  codes=codes, alive=dead1,
                                                  **kw), 2)
        free()
        nb, fl = opt_step_cost(FULL_M, FULL_P, "momentum", True)
        if mode == "mean":
            mb, mf = mix_disp_cost(FULL_M, FULL_P)
            nb, fl = nb + mb, fl + mf
        eb, ef = fault_extra_cost(FULL_P, 2, 3)
        record_fault(f"opt_step/fault-{mode}-codes", k_ms, p_ms,
                     masked_opt_step_cost(FULL_M, FULL_P, "momentum", True,
                                          3, 0, event=mode != "none"),
                     pr20_cost=(nb + eb, fl + ef))
    # a straggler too (row 0 alive, skipping its update), checked only
    fault_err["opt_step"] = max(fault_err["opt_step"], cc.check_opt_step_fault(
        "opt_step/full-fault-straggle-none", x, g, st, scal, codes, dead1,
        np.array([0, 0, 1, 1], np.float32), kind="momentum", mu=0.9,
        mode="none"))
    del g, st
    free()
    r = cc.wire_inputs(dev, FULL_M, FULL_P, seed=18, uniforms=False)[0]
    ckw = dict(wire="one_bit", mode="mix", W=ring, codes=codes)
    fault_err["compressed_mix"] = max(
        fault_err["compressed_mix"],
        cc.check_compressed_fault("compressed_mix/full-fault-one_bit-ring",
                                  x, r, dead1, **ckw))
    free()
    xk, rk = x.clone(), r.clone()
    k_ms = cuda_time(lambda: compressed_mix(xk, rk, alive=dead1, **ckw), 5)
    del xk, rk
    free()
    p_ms = cuda_time(lambda: ref.compressed_mix_ref(
        x, r, ring, wire="one_bit", codes=codes, alive=dead1), 2)
    free()
    nb, fl = compressed_cost(FULL_M, FULL_P, "one_bit", True, mix=True)
    eb, ef = fault_extra_cost(FULL_P, 2, 3)
    record_fault("compressed_mix/fault-one_bit-ring-codes", k_ms, p_ms,
                 masked_compressed_cost(FULL_M, FULL_P, "one_bit", True, 3,
                                        mix=True),
                 pr20_cost=(nb + eb, fl + ef))
    # the bf16 wire's masked mean (the event matrix), checked only
    fault_err["compressed_mix"] = max(
        fault_err["compressed_mix"],
        cc.check_compressed_fault("compressed_mix/full-fault-bf16-mean", x,
                                  r, dead1, wire="bf16", mode="mean",
                                  codes=codes))
    del r, x
    free()
    # the masked mean and mix in their kernels, f32 and with the bf16
    # codes, timed on a clone (they run in place); beside them PR 20's
    # wrapped path (mix_disp.cu + the masked dispersion) and, for the
    # mix, torch.matmul over the degraded W
    x = cc.make_inputs(dev, FULL_M, FULL_P, "sgd", seed=19)[0]
    w_dead = degraded_matrix(ring, dead1)
    nb, fl = mix_disp_cost(FULL_M, FULL_P)
    eb, ef = fault_extra_cost(FULL_P, 0, 3)
    for cd in (None, codes):
        suffix = "-codes" if cd is not None else ""
        for name, kname, check_fn, run_k, run_p, lib in (
                (f"avg_disp/fault-g1{suffix}", "avg_disp",
                 lambda n_: cc.check_avg_disp_fault(n_, x, dead1, 1, cd),
                 lambda v: avg_disp(v, codes=cd, alive=dead1),
                 lambda: ref.plane_average_ref(x, codes=cd, alive=dead1),
                 None),
                (f"mix_disp/fault-ring{suffix}", "mix_disp",
                 lambda n_: cc.check_mix_disp_fault(n_, x, ring, dead1, cd),
                 lambda v: mix_disp(v, ring, codes=cd, alive=dead1),
                 lambda: ref.mix_disp_ref(x, ring, codes=cd, alive=dead1),
                 lambda: torch.matmul(w_dead, x))):
            fault_err[kname] = max(fault_err[kname],
                                   check_fn(name.replace("/", "/full-")))
            free()
            xk = x.clone()
            k_ms = cuda_time(lambda: run_k(xk), 5)
            del xk
            free()
            p_ms = cuda_time(run_p, 2)
            free()
            record_fault(name, k_ms, p_ms,
                         masked_event_cost(FULL_M, FULL_P, 3, cd is not None,
                                           mix=kname == "mix_disp"),
                         pr20_cost=(nb + eb, fl + ef))
            if lib is not None:
                ff[name]["library_ms"] = cuda_time(lib, 5)
                free()
    fault_err["avg_disp"] = max(fault_err["avg_disp"], cc.check_avg_disp_fault(
        "avg_disp/full-fault-g2", x, dead1, 2))
    del x, codes, w_dead
    free()

    part_s["full_width"] = time.perf_counter() - tp
    tp = time.perf_counter()
    # smollm-360m training at full width under the plan, beside the same
    # runs without it: 7 unprofiled steps (the first phase warms up), then
    # 1 under the profiler (2 until phase 14 needed the time)
    plan_argv = ["--faults", "crash:m=1@t=3,rejoin:m=1@t=6",
                 "--straggle-prob", "0.25", "--rejoin-curriculum", "2"]
    fault_lm = {}
    for name, extra, expect, expect_no_plan, events in (
            ("periodic", ["--avg", "periodic", "--phase-len", "2"],
             {"opt_step": 8, "avg_disp": 4}, {"opt_step": 8, "avg_disp": 4},
             4),
            ("minibatch", ["--avg", "minibatch"],
             {"opt_step": 8}, {"opt_step": 8}, 8),
            ("periodic-ring-one_bit",
             ["--avg", "periodic", "--phase-len", "2", "--topology", "ring",
              "--comm-dtype", "one_bit"],
             {"opt_step": 8, "compressed_mix": 4},
             {"opt_step": 8, "compressed_mix": 4}, 4)):
        pair = {}
        for with_plan in (True, False):
            torch.cuda.reset_peak_memory_stats(dev)
            ap = train.make_parser()
            args = ap.parse_args(common + ["--steps", "8"] + extra
                                 + (plan_argv if with_plan else []))
            _, engine, params, batches = train.setup(args, ap)
            data = batches()
            zero_counts()
            _, hist, state = engine.run(params, data, num_workers=4, seed=0,
                                        steps=7, record_every=1,
                                        phase_len=2, return_state=True)
            torch.cuda.synchronize(dev)
            # kernels only: the device's busy time needs no host op
            # records, which at ~27,000 launches a step cost minutes
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                _, hist2, state = engine.run(None, data, num_workers=4,
                                             steps=1, state=state,
                                             record_every=1, phase_len=2,
                                             return_state=True)
                torch.cuda.synchronize(dev)
            step_ms = steady_step_ms(hist["phase_wall"])
            got = read_counts(expect if with_plan else expect_no_plan,
                              f"faults {name} plan={with_plan}")
            losses = [v for _, v in hist["loss"] + hist2["loss"]]
            check(len(losses) == 8 and all(map(math.isfinite, losses)),
                  f"faults {name}: losses {losses}")
            check(hist["averages"] + hist2["averages"] == events,
                  f"faults {name}: events")
            check(all(torch.equal(row, row.to(torch.bfloat16).float())
                      for row in state.plane), f"faults {name}: bf16 grid")
            run = dict(step_ms=step_ms,
                       max_memory_gb=torch.cuda.max_memory_allocated(dev)
                       / 1e9, loss_last=losses[-1], launches=got,
                       **{k: v for k, v in _breakdown(prof, 1, step_ms * 1e3)
                          .items() if k in ("device_busy_ms", "idle_share",
                                            "by_group_ms")})
            check(run["device_busy_ms"] > 0, f"faults {name}: no kernel "
                  "in the profile")
            if with_plan:
                check(state.fault.alive.tolist() == [1.0] * 4,
                      f"faults {name}: alive {state.fault.alive}")
                run["staleness"] = state.fault.staleness.tolist()
            pair["plan" if with_plan else "no_plan"] = run
            del engine, params, state, hist, hist2, prof
            free()
        pair["plan_minus_no_plan"] = {
            k: pair["plan"][k] - pair["no_plan"][k]
            for k in ("step_ms", "device_busy_ms", "max_memory_gb")}
        fault_lm[name] = pair

    part_s["smollm_360m"] = time.perf_counter() - tp
    tp = time.perf_counter()
    # the least squares of phase 4 under the plan: each run on the card
    # and on the CPU
    c = CONVEX_SUITE[0]
    X, y, _ = convex_dataset(c.model, c.num_samples, c.num_dims,
                             sparsity=c.sparsity, noise=c.noise, seed=0)
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    plan = FaultPlan.parse("crash:m=3@t=40,crash:m=7@t=40,rejoin:m=3@t=120",
                           mw, straggle_prob=0.1, rejoin_curriculum=16)
    idx = np.random.default_rng(2).integers(0, c.num_samples,
                                            (FAULT_LS_STEPS, mw))
    lr0_f = 0.8 * 200.0 / float(np.mean(np.sum(X * X, axis=1)))
    sgd_f = SGD(lr=lambda t: lr0_f / (t - 1.0 + 200.0))

    def ls_run(sched, device, faults=plan, host=False, steps=FAULT_LS_STEPS,
               idx_=idx, every=1, eval_fn=None, **comm):
        eng = PhaseEngine(convex_loss("ls"), sgd_f, sched, device=device,
                          faults=faults, **comm)
        w0 = {"w": torch.zeros(c.num_dims, device=device)}
        kw = dict(num_workers=mw, seed=0, record_every=every,
                  eval_fn=eval_fn)
        if host:
            return eng.run_host(w0, ({"x": X[i], "y": y[i]} for i in idx_),
                                **kw)
        Xs, ys = Xd.to(device), yd.to(device)
        return eng.run(w0, DeviceDataset({"x": Xs, "y": ys}, mw,
                                         indices=idx_, device=device),
                       steps=steps, return_state=True, **kw)

    periodic16 = AveragingSchedule("periodic", phase_len=16)
    ls = {}
    thr = None
    for name, sched, comm, expect, fp in (
            ("periodic", periodic16, {}, "avg_disp", plan),
            ("hierarchical", AveragingSchedule(
                "hierarchical", inner_groups=2, inner_phase_len=8,
                outer_phase_len=32), {}, "avg_disp", plan),
            ("ring", periodic16, dict(topology=Topology.ring(mw)),
             "mix_disp", plan),
            ("int8", periodic16, dict(compression=int8), "compressed_mix",
             plan),
            ("int8-no-plan", periodic16, dict(compression=int8),
             "compressed_mix", None),
            ("minibatch-torus-int8", AveragingSchedule("minibatch"),
             dict(topology=Topology.torus(mw), compression=int8),
             "compressed_mix", plan),
            ("adaptive_threshold", None, {}, "avg_disp", plan),
            ("adaptive_threshold-aware", None, {}, "avg_disp", plan)):
        if sched is None:
            sched = AveragingSchedule("adaptive_threshold",
                                      disp_threshold=thr,
                                      straggle_aware=name.endswith("aware"))
        zero_counts()
        t0 = time.perf_counter()
        fg, hg, sg = ls_run(sched, "cuda", faults=fp, **comm)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        events = hg["averages"]
        got = read_counts({"opt_step": FAULT_LS_STEPS, expect: events},
                          f"ls {name}")
        t0_cpu = time.perf_counter()
        fc, hc, sc = ls_run(sched, "cpu", faults=fp, **comm)
        cpu_s = time.perf_counter() - t0_cpu
        check([t for t, _ in hg["dispersion"]] == [t for t, _ in
                                                    hc["dispersion"]]
              and events > 0, f"ls {name}: event steps cuda vs cpu")
        if fp is not None:
            check(np.array_equal(sg.fault.alive, sc.fault.alive)
                  and np.array_equal(sg.fault.staleness,
                                     sc.fault.staleness),
                  f"ls {name}: fault rows cuda vs cpu")
        spread = None
        if "compression" in comm:
            # int8's floor lands one quantum apart where the devices'
            # gradients differ in the last bit (phase 4), and over the
            # steps those flips spread through the gradients: held on
            # the objective, the spread reported (with and without the
            # plan)
            d = (sg.plane.cpu() - sc.plane).abs()
            spread = dict(
                beyond_rtol_1e4=int((d > 1e-6 + 1e-4 * sc.plane.abs())
                                    .sum()), entries=d.numel(),
                max_quanta=float(d.max()) * 127.0
                / float(sc.plane.abs().max()))
            f_g, f_c = objective(fg["w"]), objective(fc["w"])
            check(math.isclose(f_g, f_c, rel_tol=1e-3),
                  f"ls {name}: objective {f_g} on the card, {f_c} on the "
                  "CPU")
        else:
            np.testing.assert_allclose([v for _, v in hg["loss"]],
                                       [v for _, v in hc["loss"]],
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"ls {name}: losses")
            np.testing.assert_allclose(fg["w"].cpu().numpy(),
                                       fc["w"].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"ls {name}")
        if name == "periodic":
            # the adaptive runs trip at half the median pre-event
            # dispersion of this run
            thr = 0.5 * float(np.median([d for _, d in hg["dispersion"]]))
            fh, hh = ls_run(sched, "cuda", host=True)
            check(torch.equal(fh["w"], fg["w"]) and hh["loss"] == hg["loss"]
                  and hh["dispersion"] == hg["dispersion"],
                  "ls periodic: run_host differs from run on the card")
        ls[name] = dict(events=events, launches=got, wall_s=wall,
                        cpu_twin_s=cpu_s,
                        step_ms=steady_step_ms(hg["phase_wall"]),
                        objective_end=objective(fg["w"]),
                        int8_spread_vs_cpu=spread)
        if fp is not None:
            ls[name].update(alive=sg.fault.alive.tolist(),
                            staleness_max=int(sg.fault.staleness.max()))
        del fg, hg, sg, fc, hc, sc
    check(ls["adaptive_threshold-aware"]["events"]
          <= ls["adaptive_threshold"]["events"],
          "straggle_aware took more events than the unaware schedule")
    ls["run_host_bitwise_run"] = "periodic"
    ls["adaptive_threshold_disp_threshold"] = thr

    part_s["least_squares"] = time.perf_counter() - tp
    tp = time.perf_counter()
    # one paired curve: periodic 128 with and without the plan, the
    # objective every 64 steps, on one index list
    from repro_torch.models.convex import solve_optimum
    w_star = solve_optimum("ls", Xd, yd)
    f0, fstar = objective(torch.zeros(c.num_dims)), objective(w_star)
    idx_c = np.random.default_rng(0).integers(0, c.num_samples,
                                              (FAULT_CURVE_STEPS, mw))
    curve = {}
    for name, fp in (("plan", plan), ("no_plan", None)):
        zero_counts()
        _, hc_, _ = ls_run(AveragingSchedule("periodic", phase_len=128),
                           "cuda", faults=fp, steps=FAULT_CURVE_STEPS,
                           idx_=idx_c, every=SUITE_EVERY,
                           eval_fn=lambda p_: objective(p_["w"]))
        read_counts({"opt_step": FAULT_CURVE_STEPS,
                     "avg_disp": FAULT_CURVE_STEPS // 128}, f"curve {name}")
        curve[name] = [(t, (v - fstar) / (f0 - fstar)) for t, v in
                       hc_["eval"]]
    del Xd, yd, w_star
    free()
    part_s["curve"] = time.perf_counter() - tp
    emit({"phase": "faults", "sweep_cases": n_fault,
          "sweep_s": fault_sweep_s, "part_s": part_s,
          "max_abs_err": fault_err,
          "full_width": {"M": FULL_M, "P": FULL_P, "alive": dead1.tolist(),
                         **ff},
          "smollm_360m": {"plan": " ".join(plan_argv), **fault_lm},
          "least_squares": {"config": c.name, "steps": FAULT_LS_STEPS,
                            "plan": "crash:m=3@t=40,crash:m=7@t=40,"
                                    "rejoin:m=3@t=120",
                            "straggle_prob": 0.1, "rejoin_curriculum": 16,
                            **ls},
          "curve_periodic_128": {"steps": FAULT_CURVE_STEPS, "f0": f0,
                                 "f_star": fstar, **curve},
          "wall_s": time.perf_counter() - t_faults, "card": smi})

    # ---- 8. elastic membership and checkpoints ------------------------------
    import os
    import shutil
    import tempfile

    from repro_torch import elastic
    from repro_torch.checkpoint import io as ckio
    t_el = time.perf_counter()
    part_s = {}
    tp = time.perf_counter()
    # (a) smollm-360m at full width through the CLI's setup and plan:
    # shrink 4 -> 2 before step 3, grow back to 4 before step 5 (the grown
    # rows one solo step), driven in five run_elastic calls so that each
    # call's peak memory is read: the resize with its segment's first
    # step, then the segment's other steps (training alone)
    el_argv = common + ["--avg", "periodic", "--phase-len", "2",
                        "--shrink-at", "3:2", "--grow-at", "5:4",
                        "--rejoin-curriculum", "1"]
    ap = train.make_parser()
    args = ap.parse_args(el_argv + ["--steps", "8"])
    _, engine, params, batches = train.setup(args, ap)
    plan = train.elastic_plan(args, ap)
    check(plan.resizes == ((3, 2), (5, 4)) and plan.curriculum == 1,
          f"elastic plan {plan}")

    def cli_data(m, t0, k, b=batches):
        return b(m, k)
    zero_counts()
    # the state rides in a list that the call pops, so that this frame
    # holds no reference to it during the call: a resize frees the old
    # planes as one run_elastic call over all the steps does
    carry, calls, losses, resizes, events = [None], [], [], [], 0
    for stop in (2, 3, 4, 5, 8):
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        out = elastic.run_elastic(
            engine, params, cli_data, plan, steps=stop, seed=args.seed,
            record_every=1, state=carry.pop(), return_state=True,
            phase_len=1)
        torch.cuda.synchronize(dev)
        h, state = out[1], out[2]
        del out
        for t_, old_m, new_m in h["resizes"]:
            kind = "shrink" if new_m < old_m else "grow"
            print(f"[train] {kind} {old_m} -> {new_m} workers before step "
                  f"{t_}", flush=True)
        calls.append(dict(
            steps=[h["phase_wall"][0][0], stop],
            workers=state.plane.shape[0],
            resizes=h["resizes"], wall_s=time.perf_counter() - t,
            step_ms=[1e3 * w for *_, w in h["phase_wall"]],
            peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
            allocated_after_gb=torch.cuda.memory_allocated(dev) / 1e9))
        losses += [v for _, v in h["loss"]]
        resizes += h["resizes"]
        events += h["averages"]
        carry.append(state)
        del state
    state = carry.pop()
    got = read_counts({"opt_step": 8, "avg_disp": 4}, "elastic smollm")
    check(resizes == [(3, 4, 2), (5, 2, 4)], f"resizes {resizes}")
    check(events == 4 and len(losses) == 8
          and all(map(math.isfinite, losses)), f"elastic: {events} events, "
          f"losses {losses}")
    check(state.plane.shape == (FULL_M, FULL_P) and all(
        torch.equal(r, r.to(torch.bfloat16).float()) for r in state.plane),
        "elastic: the plane's shape or its bf16 grid")
    el_a = state
    el_lm = dict(plan=" ".join(el_argv[-6:]), steps=8, resizes=resizes,
                 averages=events, launches=got, loss_first=losses[0],
                 loss_last=losses[-1], calls=calls)
    del h
    # the trivial plan (a no-op resize at 3) against the plain run, 4 steps
    # each from the same init and streams: bitwise on the card
    triv = {}
    for name in ("trivial", "plain"):
        args4 = ap.parse_args(common + ["--avg", "periodic", "--phase-len",
                                        "2", "--steps", "4"])
        _, eng4, params4, batches4 = train.setup(args4, ap)
        zero_counts()
        if name == "trivial":
            out = elastic.run_elastic(
                eng4, params4, lambda m, t0, k, b=batches4: b(m, k),
                elastic.ElasticPlan(FULL_M, ((3, FULL_M),)), steps=4,
                seed=0, record_every=1, return_state=True)
        else:
            out = eng4.run(params4, batches4(), num_workers=FULL_M, seed=0,
                           record_every=1, return_state=True)
        read_counts({"opt_step": 4, "avg_disp": 2}, f"elastic {name}")
        triv[name] = (out[1]["loss"], out[2])
        del out, params4
    check(triv["trivial"][0] == triv["plain"][0]
          and torch.equal(triv["trivial"][1].plane, triv["plain"][1].plane)
          and all(torch.equal(a_, b_) for a_, b_ in zip(
              triv["trivial"][1].opt_planes, triv["plain"][1].opt_planes)),
          "the trivial elastic plan is not the plain run on the card")
    el_lm["trivial_plan_bitwise_plain"] = True
    del triv, engine, params
    free()
    part_s["smollm_360m"] = time.perf_counter() - tp
    tp = time.perf_counter()

    # (b) the same run through the CLI, checkpointed at step 4 (M=2) into
    # a temporary directory and resumed for 4 more steps: bitwise (a)
    timing = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize(dev)
            timing[name] = time.perf_counter() - t
            return out
        return run
    saved = {n: getattr(train, n) for n in ("save_checkpoint",
                                            "save_engine_state",
                                            "load_engine_state")}
    for n, fn in saved.items():
        setattr(train, n, timed(f"{n}_s", fn))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    try:
        ck = os.path.join(tmp, "run")
        zero_counts()
        train.main(el_argv + ["--steps", "4", "--checkpoint", ck])
        nbytes = {f: os.path.getsize(os.path.join(tmp, f))
                  for f in sorted(os.listdir(tmp))}
        meta = json.load(open(ck + ".state.json"))["extra"]
        check(meta["engine_state_version"] == 5
              and meta["num_workers"] == 2, f"checkpoint meta {meta}")
        _, _, st_b = train.main(el_argv + ["--steps", "4", "--resume",
                                           ck + ".state"])
        got = read_counts({"opt_step": 8, "avg_disp": 4}, "checkpoint CLI")
    finally:
        for n, fn in saved.items():
            setattr(train, n, fn)
        shutil.rmtree(tmp)
    check(not os.path.exists(tmp), "checkpoint files left behind")
    bitwise = (torch.equal(st_b.plane, el_a.plane)
               and all(torch.equal(a_, b_) for a_, b_ in
                       zip(st_b.opt_planes, el_a.opt_planes))
               and np.array_equal(st_b.fault.alive, el_a.fault.alive))
    check(bitwise, "checkpoint at step 4 and resume: not bitwise the "
          "uninterrupted run on the card (max |diff| "
          f"{float((st_b.plane - el_a.plane).abs().max())})")
    el_ck = dict(step=4, workers_at_save=2, version=5, bytes=nbytes,
                 bytes_total=sum(nbytes.values()), **timing,
                 launches=got, resumed_bitwise_uninterrupted=bitwise)
    del st_b, el_a, state
    free()
    part_s["checkpoint"] = time.perf_counter() - tp
    tp = time.perf_counter()

    # (c) the least squares at 24 workers under an elastic plan and a
    # fault plan, on the card against the CPU port: shrink to 16 before
    # step 64, grow back to 24 before step 160 (16 solo steps)
    c = CONVEX_SUITE[0]
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    eplan = elastic.ElasticPlan(mw, ((64, 16), (160, mw)), curriculum=16)
    base = FaultPlan.parse("crash:m=3@t=40,rejoin:m=3@t=120", mw,
                           straggle_prob=0.1, rejoin_curriculum=16)
    idx_e = np.random.default_rng(3).integers(0, c.num_samples, (256, mw))

    def ls_elastic(device):
        Xs, ys = Xd.to(device), yd.to(device)
        eng = PhaseEngine(convex_loss("ls"), sgd_f,
                          AveragingSchedule("periodic", phase_len=16),
                          device=device, faults=base)

        def data(m, t0, k):
            return DeviceDataset({"x": Xs, "y": ys}, m,
                                 indices=idx_e[t0 - 1:t0 - 1 + k, :m],
                                 device=device)
        return elastic.run_elastic(
            eng, {"w": torch.zeros(c.num_dims, device=device)}, data,
            eplan, steps=256, seed=0, record_every=1, return_state=True)

    zero_counts()
    t0 = time.perf_counter()
    fg, hg, sg = ls_elastic("cuda")
    torch.cuda.synchronize(dev)
    card_s = time.perf_counter() - t0
    got = read_counts({"opt_step": 256, "avg_disp": hg["averages"]},
                      "ls elastic")
    t0 = time.perf_counter()
    fc, hc, sc = ls_elastic("cpu")
    cpu_s = time.perf_counter() - t0
    check(hg["resizes"] == hc["resizes"] == [(64, 24, 16), (160, 16, 24)]
          and [t_ for t_, _ in hg["dispersion"]]
          == [t_ for t_, _ in hc["dispersion"]] and hg["averages"] == 16,
          "ls elastic: resizes or event steps, card against CPU")
    check(np.array_equal(sg.fault.alive, sc.fault.alive)
          and np.array_equal(sg.fault.staleness, sc.fault.staleness),
          "ls elastic: fault rows, card against CPU")
    np.testing.assert_allclose([v for _, v in hg["loss"]],
                               [v for _, v in hc["loss"]], rtol=1e-4,
                               atol=1e-7, err_msg="ls elastic: losses")
    np.testing.assert_allclose(fg["w"].cpu().numpy(), fc["w"].numpy(),
                               rtol=1e-4, atol=1e-6, err_msg="ls elastic")
    el_ls = dict(config=c.name, steps=256, plan="shrink 64:16, grow 160:24, "
                 "curriculum 16", faults="crash:m=3@t=40,rejoin:m=3@t=120",
                 straggle_prob=0.1, resizes=hg["resizes"],
                 events=hg["averages"], launches=got, card_s=card_s,
                 cpu_twin_s=cpu_s, objective_end=objective(fg["w"]),
                 alive=sg.fault.alive.tolist(),
                 cuda_vs_cpu="losses rtol 1e-4 / atol 1e-7, params rtol "
                             "1e-4 / atol 1e-6")
    del fg, hg, sg, fc, hc, sc, Xd, yd
    free()
    part_s["least_squares"] = time.perf_counter() - tp
    emit({"phase": "elastic_checkpoint", "part_s": part_s,
          "smollm_360m": el_lm, "checkpoint": el_ck, "least_squares": el_ls,
          "wall_s": time.perf_counter() - t_el, "card": smi})

    # ---- 9. telemetry -------------------------------------------------------
    emit(dict(phase_telemetry(cx), card=smi))

    # ---- 10. the paper's §3.2 CNN, and the theory ---------------------------
    emit(dict(phase_paper_cnn(cx), card=smi))
    emit(dict(phase_paper_nonconvex(cx), card=smi))

    # ---- 11. the sharded plane ---------------------------------------------
    cx.add_counts = add_counts
    cx.lm_periodic = lm_periodic
    emit(dict(phase_sharded(cx), phase="sharded", card=smi))
    del lm_periodic

    # ---- 12. the decoder-only zoo -------------------------------------------
    emit(dict(phase_zoo(cx), card=smi))

    # ---- 13. encoders and cross-attention ----------------------------------
    emit(dict(phase_encdec(cx), card=smi))

    # ---- 14. the tree and unfused carries, steps, banded ------------------
    cx.train_run = train_run
    cx.launch_us = launch_us
    cx.lm_one_bit = lm_kept.pop("periodic-ring-one_bit")
    emit(dict(phase_tree(cx), card=smi))
    del cx.lm_one_bit, cx.lm_periodic

    # ---- 15. the dry run, the roofline and the examples --------------------
    emit(dict(phase_dryrun(cx), card=smi))

    # ---- 16. summary -------------------------------------------------------
    def line(name, src, replaces, row, fault=None):
        out = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}.cu",
               "replaces": replaces, "launches": main_launches[name],
               "max_abs_err": err[name], "ms": row["ms"],
               "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
               "bound_by": row["bound_by"],
               "library_ms": row.get("library_ms")}
        if fault is not None:
            # the masked pass in the kernel at full width, one dead row
            out.update(fault_ms=fault["ms"], fault_bound_ms=fault["bound_ms"])
        return out

    summary = [
        line("opt_step", "opt_step", "src/repro/kernels/opt_step.py:185",
             full["opt_step/none"], ff["opt_step/fault-none-codes"]),
        line("avg_disp", "avg_disp", "src/repro/kernels/avg_disp.py:156",
             full["avg_disp/g1"], ff["avg_disp/fault-g1"]),
        line("mix_disp", "mix_disp", "src/repro/kernels/avg_disp.py:203",
             full["mix_disp/ring"], ff["mix_disp/fault-ring"]),
        dict(line("avg_disp_outer", "avg_disp_outer",
                  "src/repro/kernels/avg_disp.py:251",
                  full["avg_disp_outer/nesterov-codes"]),
             f32_ms=full["avg_disp_outer/nesterov"]["ms"],
             f32_bound_ms=full["avg_disp_outer/nesterov"]["bound_ms"]),
        line("compressed_mix", "compressed_mix",
             "src/repro/kernels/avg_disp.py:295",
             full["compressed_mix/one_bit-mix-codes"],
             ff["compressed_mix/fault-one_bit-ring-codes"]),
        line("flash_attention", "flash_attention",
             "src/repro/kernels/flash_attention.py:75",
             full["flash_attention/recurrentgemma-2b"]),
        line("rglru_scan", "rglru_scan", "src/repro/kernels/rglru_scan.py:46",
             full["rglru_scan/recurrentgemma-2b"]),
        line("rwkv6_scan", "rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:47",
             full["rwkv6_scan/rwkv6-7b"])]
    # the static registry against what the card ran: the discovered
    # kernels, each launched on the main path and held against its plain
    # version in this call
    names = sorted(k["name"] for k in summary)
    check(names == static["kernels"], f"kernels line {names} is not the "
          f"set phase 0 discovered, {static['kernels']}")
    for k in summary:
        check(k["launches"] >= 1 and math.isfinite(k["max_abs_err"]),
              f"{k['name']}: launches {k['launches']}, max_abs_err "
              f"{k['max_abs_err']}")
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind_name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
