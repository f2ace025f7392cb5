"""Training CLI: local-SGD training of a language model on the card.

The counterpart of ``repro.launch.train`` for the flags the port
supports. M workers each read their own synthetic token stream
(``token_stream(seed * 131 + i)``, the reference's streams), take local
steps through :class:`repro_torch.core.PhaseEngine`, and average on the
chosen schedule, over the chosen topology (``--topology``) and wire
format (``--comm-dtype``), optionally with the outer optimizer
(``--outer-momentum``), and under scripted worker faults (``--faults``,
``--straggle-prob``, ``--rejoin``, ``--rejoin-curriculum``,
``--straggle-aware``), with elastic membership (``--shrink-at`` /
``--grow-at STEP:M'``, :mod:`repro_torch.elastic`). ``--checkpoint PATH``
writes the consensus model to ``PATH`` and the full engine state to
``PATH.state`` (:mod:`repro_torch.checkpoint`, the reference's format);
``--resume PATH.state`` continues such a run for ``--steps`` more steps,
bitwise as if it had not stopped: unlike the reference CLI, whose
streams restart at their first batch on a resume, each row's stream
skips the batches that row has taken. ``--telemetry PATH`` writes the
run's structured records (:mod:`repro_torch.telemetry`) to a JSONL file,
rendered by ``python -m repro_torch.telemetry.report PATH``;
``--profile-dir DIR`` traces the run with ``torch.profiler``. Runs on
CUDA unless ``--device cpu``; ``--kernel-impl ref`` takes the kernels'
plain versions on the card and ``--no-prefetch`` stages the batches in
line, for comparison. ``--tree-engine`` and ``--no-fused-opt`` pick the
engine's ``tree`` and ``flat`` carries (``PhaseEngine(flat=,
fused_opt=)``); ``--scan-unroll`` is the reference's scan unroll, which
the port's Python loop has no use for: accepted and recorded, so the
reference's command lines run unchanged.

``--shard`` splits the worker rows over the ranks ``torchrun`` starts
(:mod:`repro_torch.launch.mesh`; a plain ``python -m`` is a world of
one), over NCCL on CUDA and gloo on the CPU, with ``--collective psum``
(the default) or ``gather`` (:class:`repro_torch.core.PhaseEngine`).
Rank 0 prints, writes the telemetry and, under ``--checkpoint``, gathers
the rows and writes the files; ``--resume`` loads on every rank, each
keeping its rows.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 6 --workers 4 --avg periodic --phase-len 3
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --device cpu --reduced --steps 6 \
      --workers 4 --avg periodic --phase-len 3 --shard
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (ENGINE_STATE_VERSION, load_engine_state,
                                    save_checkpoint, save_engine_state)
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import AveragingSchedule, PhaseEngine
from repro_torch.core.averaging import OuterOptimizer
from repro_torch.core.compress import WIRE_FORMATS, Compression
from repro_torch.data import token_stream
from repro_torch.device import resolve_device
from repro_torch.elastic import ElasticPlan, run_elastic, segment_engine
from repro_torch.faults import FaultPlan
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.models import init_params, lm_loss
from repro_torch.optim import AdamW, Momentum
from repro_torch.sharding.specs import unshard_engine_state
from repro_torch.telemetry import (JsonlSink, make_record, profile_trace,
                                   run_meta_record)
from repro_torch.topology import KINDS as TOPOLOGY_KINDS
from repro_torch.topology import Topology, comm_bytes

AVG_KINDS = ("oneshot", "minibatch", "periodic", "stochastic",
             "hierarchical", "adaptive_threshold", "adaptive_budget",
             "adaptive_bytes")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer, d_model 256 variant in float32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--avg", default="periodic", choices=AVG_KINDS)
    ap.add_argument("--phase-len", type=int, default=10)
    ap.add_argument("--zeta", type=float, default=0.01,
                    help="stochastic: per-step averaging probability "
                         "(0 < zeta <= 1)")
    ap.add_argument("--inner-groups", type=int, default=2,
                    help="hierarchical averaging: number of inner worker "
                         "groups (must divide --workers)")
    ap.add_argument("--outer-phase-len", type=int, default=0,
                    help="hierarchical averaging: all-worker period "
                         "(default 0 -> 8 x --phase-len)")
    ap.add_argument("--disp-threshold", type=float, default=0.0,
                    help="adaptive_threshold: average when the running "
                         "EMA of the Eq. 4 worker dispersion crosses "
                         "this level (required > 0)")
    ap.add_argument("--disp-ema-beta", type=float, default=0.9)
    ap.add_argument("--comm-budget", type=int, default=0,
                    help="adaptive_budget: max averaging events over "
                         "the budget horizon (required >= 1)")
    ap.add_argument("--budget-horizon", type=int, default=0,
                    help="adaptive_budget / adaptive_bytes: steps the "
                         "budget spans (default 0 -> --steps)")
    ap.add_argument("--comm-dtype", default="f32",
                    choices=list(WIRE_FORMATS),
                    help="wire precision of averaging/mixing events: f32 "
                         "ships the rows uncompressed; bf16/int8/one_bit "
                         "quantize them, int8/one_bit with an "
                         "error-feedback residual plane")
    ap.add_argument("--byte-budget", type=int, default=0,
                    help="adaptive_bytes: max bytes ONE worker puts on "
                         "the wire over the budget horizon (required "
                         ">= the cost of one event at the chosen "
                         "topology x --comm-dtype)")
    ap.add_argument("--error-feedback", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="carry the error-feedback residual plane "
                         "(required for int8/one_bit; "
                         "--no-error-feedback is only valid for bf16)")
    ap.add_argument("--topology", default=None,
                    choices=list(TOPOLOGY_KINDS),
                    help="mixing topology of the averaging events: every "
                         "event becomes one doubly-stochastic W @ plane "
                         "mix over this graph; 'full' is bit-identical "
                         "to the default mean, 'groups' to the "
                         "group-mean")
    ap.add_argument("--topology-groups", type=int, default=2,
                    help="--topology groups: number of block-diagonal "
                         "worker groups (must divide --workers)")
    ap.add_argument("--outer-momentum", type=float, default=0.0,
                    help=">0 enables the DiLoCo-style outer optimizer "
                         "at averaging steps")
    ap.add_argument("--faults", default=None,
                    help="deterministic fault script: comma-separated "
                         "kind:m=<row>@t=<step> events, e.g. "
                         "'crash:m=3@t=100,rejoin:m=3@t=200' — crashed "
                         "rows drop out of every update and averaging "
                         "event, rejoining rows warm-start from the "
                         "alive consensus")
    ap.add_argument("--straggle-prob", type=float, default=0.0,
                    help="per-worker per-step probability of skipping "
                         "the local update (the row still receives the "
                         "event), drawn from the decision key's stream")
    ap.add_argument("--rejoin", type=int, default=0,
                    help="auto-rejoin every scripted crash N steps later "
                         "(crashes with a later scripted event for the "
                         "same worker are left alone)")
    ap.add_argument("--shrink-at", action="append", default=[],
                    metavar="STEP:M'",
                    help="elastic membership: shrink the worker plane to "
                         "M' rows before STEP runs — the dropped rows' "
                         "memory and compute are freed (repeatable; "
                         "composes with --grow-at)")
    ap.add_argument("--grow-at", action="append", default=[],
                    metavar="STEP:M'",
                    help="elastic membership: grow the worker plane to "
                         "M' rows before STEP runs; new rows warm-start "
                         "from the mixing-cohort consensus with their "
                         "optimizer planes zeroed (repeatable)")
    ap.add_argument("--rejoin-curriculum", type=int, default=0,
                    help="solo steps a rejoined or grown worker trains "
                         "before its iterate re-enters averaging (masked "
                         "out of every event, the loss and the "
                         "dispersion)")
    ap.add_argument("--straggle-aware", action="store_true",
                    help="adaptive schedules only: discount the measured "
                         "dispersion by the fraction of the mixing cohort "
                         "that updated")
    ap.add_argument("--non-iid-alpha", type=float, default=0.0,
                    help="> 0 names Dirichlet(alpha) label-skewed worker "
                         "shards; the synthetic token stream has no "
                         "labels, so this CLI only validates it")
    ap.add_argument("--optimizer", default="momentum",
                    choices=["momentum", "adamw"])
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the planes and the model "
                         "(cuda by default; cpu runs the kernels' plain "
                         "versions)")
    ap.add_argument("--kernel-impl", default="auto",
                    choices=["auto", "ref", "cuda"],
                    help="the plane passes: auto (the CUDA kernels on the "
                         "card, their plain versions on the CPU), ref (the "
                         "plain versions) or cuda (the kernels only)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="stage phase blocks in line instead of via the "
                         "double-buffered prefetch thread")
    ap.add_argument("--tree-engine", action="store_true",
                    help="carry the params pytree through the phase "
                         "instead of the default flat (M, P) plane (the "
                         "tree averages; compressed events pack around "
                         "the event)")
    ap.add_argument("--no-fused-opt", action="store_true",
                    help="disable the flat-native fused optimizer planes: "
                         "per-step pack/unpack around the tree-mapped "
                         "optimizer, the events still the plane kernels")
    ap.add_argument("--scan-unroll", type=int, default=1,
                    help="the reference's lax.scan unroll; the port runs "
                         "a phase as a Python loop, so it is accepted, "
                         "recorded in the [train] engine line and changes "
                         "nothing")
    ap.add_argument("--shard", action="store_true",
                    help="split the (M, P) plane's worker rows over the "
                         "ranks torchrun starts (NCCL on CUDA, gloo on "
                         "the CPU; a plain python -m is one rank)")
    ap.add_argument("--collective", default="psum",
                    choices=["psum", "gather"],
                    help="sharded averaging collective: psum (one "
                         "all-reduce of column sums per step) or gather "
                         "(validation; bit-identical to one rank)")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write structured run telemetry to this JSONL "
                         "file (repro_torch.telemetry): a run_meta header, "
                         "one phase_metrics record per phase (the metrics "
                         "accumulator, folded from the values the phase "
                         "already reads), plus averaging/fault/resize/"
                         "checkpoint events — render with python -m "
                         "repro_torch.telemetry.report")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="trace the run with torch.profiler (CPU, and CUDA "
                         "on the card) into this directory "
                         "(TensorBoard-loadable)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="after the run, write the consensus model to "
                         "PATH and the full engine state to PATH.state")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="path of a full engine-state checkpoint "
                         "(--checkpoint writes <path>.state) to resume "
                         "from; --steps counts additional steps")
    return ap


def _rank0() -> bool:
    """Whether this process is the world's rank 0 (or alone)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _say(*args, **kw):
    """``print`` on the world's rank 0 only."""
    if _rank0():
        print(*args, **kw)


def _init_ranks(device: torch.device):
    """Join the process group ``torchrun`` describes in the environment
    (NCCL on CUDA, each rank on its ``LOCAL_RANK`` card; gloo on the
    CPU). Without ``torchrun``'s variables the world is this one
    process."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


def elastic_plan(args, ap) -> ElasticPlan | None:
    """The run's resize plan from ``--shrink-at`` / ``--grow-at`` (None
    without them), validated against the other flags (``ap.error``)."""
    if not (args.shrink_at or args.grow_at):
        return None
    try:
        plan = ElasticPlan.parse(args.workers, shrink_at=args.shrink_at,
                                 grow_at=args.grow_at,
                                 curriculum=args.rejoin_curriculum)
    except ValueError as e:
        ap.error(f"--shrink-at/--grow-at: {e}")
    if args.outer_momentum > 0:
        ap.error("--outer-momentum steps on a fixed-membership "
                 "consensus mean, which an elastic run never keeps "
                 "— drop --shrink-at/--grow-at or the outer "
                 "optimizer")
    for m in plan.sizes():
        # every membership the run passes through must satisfy the
        # constraints of the initial one
        if args.avg == "hierarchical" and m % args.inner_groups:
            ap.error(f"resize target M'={m} is not divisible by "
                     f"--inner-groups ({args.inner_groups}) — "
                     "hierarchical averaging needs every membership "
                     "the run passes through to split evenly")
        if args.topology and m != args.workers:
            try:
                Topology.build(args.topology, m,
                               groups=args.topology_groups)
            except ValueError as e:
                ap.error(f"resize target M'={m} is incompatible "
                         f"with --topology {args.topology}: {e}")
    return plan


def setup(args, ap):
    """Validate ``args`` (``ap.error`` on a bad combination) and build the
    run: (config, engine, initial params, batch iterator factory)."""
    family = get_config(args.arch).family
    if family in ("audio", "vlm"):
        ap.error(f"--arch {args.arch} ({family}) needs frames beside its "
                 "tokens, and the training token stream carries no frames: "
                 "it serves only (repro_torch.launch.serve)")
    if args.avg == "hierarchical":
        if args.inner_groups < 1 or args.workers % args.inner_groups:
            ap.error(f"--workers ({args.workers}) must be divisible by "
                     f"--inner-groups ({args.inner_groups})")
        outer_len = args.outer_phase_len or args.phase_len * 8
        if args.phase_len >= outer_len:
            ap.error(f"--avg hierarchical needs the inner period "
                     f"(--phase-len, {args.phase_len}) < the outer period "
                     f"(--outer-phase-len, {outer_len}); as given it "
                     "would never inner-average")
    if args.avg == "adaptive_threshold" and args.disp_threshold <= 0.0:
        ap.error("--avg adaptive_threshold needs --disp-threshold > 0 "
                 "(the Eq. 4 dispersion level that triggers averaging)")
    if args.avg == "adaptive_budget":
        horizon = args.budget_horizon or args.steps
        if args.comm_budget < 1:
            ap.error("--avg adaptive_budget needs --comm-budget >= 1")
        if args.comm_budget > horizon:
            ap.error(f"--comm-budget ({args.comm_budget}) cannot exceed "
                     f"the budget horizon ({horizon} steps): at most one "
                     "averaging event per step")
    if args.avg == "stochastic" and not 0.0 < args.zeta <= 1.0:
        ap.error(f"--avg stochastic needs 0 < --zeta <= 1, got "
                 f"{args.zeta} (other schedules ignore --zeta)")
    if args.avg == "adaptive_bytes" and args.byte_budget < 1:
        ap.error("--avg adaptive_bytes needs --byte-budget >= 1 (bytes "
                 "one worker may put on the wire over the horizon)")
    try:
        compression = Compression(args.comm_dtype,
                                  error_feedback=args.error_feedback)
    except ValueError as e:
        ap.error(f"--comm-dtype {args.comm_dtype}: {e}")
    if args.outer_momentum > 0 and args.comm_dtype != "f32":
        ap.error(f"--outer-momentum steps on the exact consensus mean, "
                 f"which a {args.comm_dtype} wire never forms — use "
                 "--comm-dtype f32 or drop the outer optimizer")
    faults = None
    if args.faults or args.straggle_prob > 0:
        if not 0.0 <= args.straggle_prob <= 1.0:
            ap.error(f"--straggle-prob must be in [0, 1], got "
                     f"{args.straggle_prob}")
        if args.rejoin < 0:
            ap.error(f"--rejoin must be >= 0, got {args.rejoin}")
        try:
            faults = FaultPlan.parse(
                args.faults or "", args.workers,
                straggle_prob=args.straggle_prob,
                rejoin_after=args.rejoin,
                rejoin_curriculum=max(args.rejoin_curriculum, 0))
        except ValueError as e:
            ap.error(f"--faults: {e}")
        if args.outer_momentum > 0:
            ap.error("--outer-momentum steps on the full-membership "
                     "consensus mean, which a faulty run never forms — "
                     "drop --faults/--straggle-prob or the outer "
                     "optimizer")
    elif args.rejoin:
        ap.error("--rejoin without --faults has no crash to rejoin "
                 "from")
    if args.rejoin_curriculum < 0:
        ap.error(f"--rejoin-curriculum must be >= 0, got "
                 f"{args.rejoin_curriculum}")
    if args.straggle_aware:
        if args.avg not in ("adaptive_threshold", "adaptive_budget",
                            "adaptive_bytes"):
            ap.error(f"--straggle-aware discounts the dispersion fed to "
                     f"the adaptive schedules; --avg {args.avg} never "
                     "consumes dispersion — use an adaptive_* schedule "
                     "or drop the flag")
        if args.straggle_prob <= 0.0:
            ap.error("--straggle-aware needs --straggle-prob > 0 — "
                     "with no stragglers there is nothing to discount")
    if elastic_plan(args, ap) is None and args.rejoin_curriculum and not (
            faults and faults.has_rejoin):
        ap.error("--rejoin-curriculum without --grow-at or a rejoin "
                 "fault event has no worker to run a curriculum for")
    if args.non_iid_alpha < 0:
        ap.error(f"--non-iid-alpha must be >= 0, got "
                 f"{args.non_iid_alpha}")
    topology = None
    if args.topology:
        try:
            topology = Topology.build(args.topology, args.workers,
                                      groups=args.topology_groups)
        except ValueError as e:
            ap.error(f"--topology {args.topology}: {e}")
        if args.outer_momentum > 0 and args.topology != "full":
            ap.error(f"--outer-momentum steps on the consensus mean, "
                     f"which --topology {args.topology} never forms — "
                     "use --topology full or drop the outer optimizer")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"--device {args.device}: {e}")
    if args.kernel_impl == "cuda" and device.type != "cuda":
        ap.error(f"--kernel-impl cuda launches the CUDA kernels, which "
                 f"--device {args.device} cannot")
    if args.scan_unroll < 0:
        ap.error(f"--scan-unroll must be >= 0, got {args.scan_unroll}")
    if args.shard and (args.tree_engine or args.no_fused_opt):
        ap.error("--shard carries the flat-native (M, P) planes: drop "
                 "--tree-engine / --no-fused-opt")
    if args.shard:
        _init_ranks(device)

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.reduced:
        cfg = dataclasses.replace(cfg, dtype="float32")
    _say(f"[train] {cfg.name}: {cfg.num_params()/1e6:.1f}M params, "
          f"{args.workers} workers, avg={args.avg}")
    if args.avg == "adaptive_bytes":
        # one event's wire cost at this topology x precision: a budget
        # below it would never average
        event_cost = comm_bytes(topology or Topology.full(args.workers),
                                1, int(cfg.num_params()), args.comm_dtype)
        if args.byte_budget < event_cost:
            ap.error(f"--byte-budget ({args.byte_budget}) is below the "
                     f"cost of ONE averaging event at this configuration "
                     f"({event_cost} B/worker: "
                     f"{args.topology or 'full'} topology, "
                     f"{args.comm_dtype} wire, "
                     f"{int(cfg.num_params())} params) — the schedule "
                     "would never fire")

    params = init_params(cfg, args.seed, device=device)

    def loss_fn(p, batch, rng):
        return lm_loss(cfg, p, batch)

    opt = (Momentum(lr=args.lr, mu=0.9) if args.optimizer == "momentum"
           else AdamW(lr=args.lr))
    sch = AveragingSchedule(
        kind=args.avg, phase_len=args.phase_len, zeta=args.zeta,
        inner_phase_len=args.phase_len,
        outer_phase_len=args.outer_phase_len or args.phase_len * 8,
        inner_groups=(args.inner_groups if args.avg == "hierarchical"
                      else 1),
        disp_threshold=args.disp_threshold,
        disp_ema_beta=args.disp_ema_beta,
        comm_budget=args.comm_budget,
        byte_budget=args.byte_budget,
        budget_horizon=args.budget_horizon or args.steps,
        straggle_aware=args.straggle_aware)
    outer = (OuterOptimizer(lr=1.0, momentum=args.outer_momentum)
             if args.outer_momentum > 0 else None)
    mesh = None
    if args.shard:
        mesh = make_worker_mesh(args.workers, device=device)
        shards = mesh.shape["data"]
        _say(f"[train] sharding {args.workers} workers over {shards} "
             f"devices ({args.workers // shards} rows/shard, "
             f"collective={args.collective}, backend={mesh.backend})")
    engine = PhaseEngine(loss_fn, opt, sch, device=str(device), outer=outer,
                         topology=topology, compression=compression,
                         kernel_impl=args.kernel_impl, faults=faults,
                         telemetry=bool(args.telemetry), mesh=mesh,
                         collective=args.collective,
                         flat=not args.tree_engine,
                         fused_opt=not args.no_fused_opt)
    carry = ("tree" if args.tree_engine else
             "flat" if args.no_fused_opt else "flat_native")
    _say(f"[train] engine: carry={carry}, scan_unroll={args.scan_unroll} "
         "(a Python loop per phase: recorded only)")
    if faults is not None and not faults.is_trivial:
        crashes = sum(ev.kind == "crash" for ev in faults.events)
        rejoins = sum(ev.kind == "rejoin" for ev in faults.events)
        _say(f"[train] faults: {crashes} crash / {rejoins} rejoin "
              f"events, straggle_prob={faults.straggle_prob}")
    if topology is not None:
        _say(f"[train] topology={topology.kind} "
              f"(spectral gap {topology.spectral_gap:.3f}, "
              f"{topology.comm_degree:.1f} msgs/worker/event)")
    if not compression.is_identity:
        _say(f"[train] wire={compression.wire} "
              f"(error_feedback={compression.error_feedback})")

    # per-worker independent data streams (the reference's seeds), keyed
    # by row: under an elastic plan a row keeps its stream across
    # resizes, so a re-grown worker continues where it left off
    streams = {}

    def stream(i):
        if i not in streams:
            streams[i] = token_stream(cfg.vocab_size, args.batch, args.seq,
                                      seed=args.seed * 131 + i)
        return streams[i]

    def batches(m=args.workers, k=args.steps, skip=None):
        """``k`` steps of batches for rows 0..m-1; ``skip`` (row ->
        count) first drops the batches those rows have taken."""
        for i, n in (skip or {}).items():
            for _ in range(n):
                next(stream(i))
        for _ in range(k):
            yield {"tokens": np.stack([next(stream(i)) for i in range(m)])}

    return cfg, engine, params, batches


def _taken(plan: ElasticPlan | None, workers: int, at: int) -> dict:
    """Row -> batches that row took in steps 1..``at``: ``at`` each at a
    fixed membership, the steps of the segments it was in under a
    plan."""
    if at < 1:
        return {}
    if plan is None:
        return dict.fromkeys(range(workers), at)
    out: dict = {}
    for seg in plan.segments(at):
        for i in range(seg.num_workers):
            out[i] = out.get(i, 0) + seg.stop - seg.start
    return out


def _resume(args, engine, params, plan):
    """(state, step) of ``--resume`` in the like-state of the run — under
    a plan, that of the segment whose row count the save recorded. Under
    ``--shard`` every rank loads the full state; the run keeps each
    rank's rows."""
    if plan is None:
        like = dataclasses.replace(engine, mesh=None).init(
            params, args.workers, args.seed)
    else:
        with open(args.resume + ".json") as f:
            meta = json.load(f)
        at = int(meta["step"])
        saved_m = (meta.get("extra") or {}).get("num_workers")
        # a save at an exact resize boundary may hold either the pre- or
        # the post-resize plane; the recorded row count picks
        seg_eng, m = segment_engine(engine, plan, at, at + args.steps)
        if saved_m is not None and int(saved_m) != m:
            seg_eng, m = segment_engine(engine, plan, at + 1,
                                        at + args.steps)
        like = dataclasses.replace(seg_eng, mesh=None).init(params, m,
                                                            args.seed)
    return load_engine_state(args.resume, like)


def _open_sink(args, engine) -> JsonlSink | None:
    """``--telemetry``'s sink, its ``run_meta`` record written (the
    reference CLI's config keys)."""
    if not args.telemetry or not _rank0():
        return None
    sink = JsonlSink(args.telemetry)
    topo = engine.topology
    sink.emit(run_meta_record(config={
        "arch": args.arch, "workers": args.workers, "steps": args.steps,
        "avg": args.avg, "phase_len": args.phase_len, "lr": args.lr,
        "optimizer": args.optimizer,
        "momentum": 0.9 if args.optimizer == "momentum" else 0.0,
        "topology": args.topology,
        "spectral_gap": topo.spectral_gap if topo is not None else None,
        "comm_dtype": args.comm_dtype, "seed": args.seed},
        device=engine.device))
    _say(f"[train] telemetry -> {args.telemetry}")
    return sink


def main(argv=None):
    """Parse ``argv``, train, print the ``[train]`` summary. Returns
    (final consensus params, history, final EngineState)."""
    ap = make_parser()
    args = ap.parse_args(argv)
    joined = dist.is_initialized()
    try:
        return _main(args, ap)
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()


def _main(args, ap):
    """:func:`main` after the parse."""
    _, engine, params, batches = setup(args, ap)
    plan = elastic_plan(args, ap)
    state, at = None, 0
    if args.resume:
        state, at = _resume(args, engine, params, plan)
        _say(f"[train] resuming from {args.resume} at step {at}")
    skip = _taken(plan, args.workers, at)
    sink = _open_sink(args, engine)
    try:
        final, hist, state = _train(args, engine, params, batches, plan,
                                    state, at, skip, sink)
    finally:
        if sink is not None:
            sink.close()
    return final, hist, state


def _train(args, engine, params, batches, plan, state, at, skip, sink):
    """The run of :func:`main` (under ``--profile-dir``'s profiler), its
    summary lines and ``--checkpoint``'s files and record."""
    t0 = time.time()
    with profile_trace(args.profile_dir):
        if plan is not None:
            first = [skip]

            def data(m, t_start, k):
                return batches(m, k, skip=first.pop() if first else None)
            final, hist, state = run_elastic(
                engine, params, data, plan, steps=at + args.steps,
                seed=args.seed, record_every=10, state=state,
                return_state=True, prefetch=not args.no_prefetch,
                sink=sink)
            for t, old_m, new_m in hist["resizes"]:
                kind = "shrink" if new_m < old_m else "grow"
                _say(f"[train] {kind} {old_m} -> {new_m} workers "
                      f"before step {t}")
        else:
            final, hist, state = engine.run(
                params, batches(args.workers, args.steps, skip=skip),
                num_workers=args.workers, seed=args.seed, record_every=10,
                prefetch=not args.no_prefetch, state=state,
                return_state=True, sink=sink)
    dt = time.time() - t0
    if args.profile_dir:
        _say(f"[train] profiler trace -> {args.profile_dir}")
    losses = hist["loss"]
    _say(f"[train] {args.steps} steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.0f} ms/step), "
          f"{hist['averages']} averaging ops")
    if losses:
        _say(f"[train] loss {losses[0][1]:.4f} -> {losses[-1][1]:.4f}")
    if hist["dispersion"]:
        _say(f"[train] final pre-average worker dispersion: "
              f"{hist['dispersion'][-1][1]:.3e}")
    if args.checkpoint:
        if engine.mesh is not None:
            # the last segment's mesh; every rank gathers, rank 0 writes
            m = (plan.segments(state.step)[-1].num_workers
                 if plan is not None else args.workers)
            mesh = make_worker_mesh(m, backend=engine.mesh.backend,
                                    device=engine.mesh.device)
            state = unshard_engine_state(state, mesh, to="cpu")
    if args.checkpoint and _rank0():
        save_checkpoint(args.checkpoint, final, step=state.step)
        save_engine_state(args.checkpoint + ".state", state,
                          elastic=plan is not None)
        _say(f"[train] saved consensus model to {args.checkpoint} "
              f"(+ resumable EngineState at {args.checkpoint}.state)")
        if sink is not None:
            sink.emit(make_record(
                "checkpoint_event", step=int(state.step),
                path=args.checkpoint + ".state",
                layout_version=ENGINE_STATE_VERSION))
    return final, hist, state


if __name__ == "__main__":
    main()
