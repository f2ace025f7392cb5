"""The dry run: every (arch x shape x mesh) step counted on ``meta``
tensors over the production mesh, and its roofline on the H100's terms.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles
each step for 256 or 512 host placeholder devices. The port has no
compiler to ask, so it counts instead (:mod:`repro_torch.roofline`):

- the mesh: the production mesh ((16, 16) or (2, 16, 16),
  ``launch/mesh.py``) over torch's ``fake`` process group of 256 or 512
  ranks, all in this one process, opened by :func:`fake_group` for each
  combination and destroyed after it (importing this module starts
  none);
- the step, on ``meta`` tensors (nothing is held on any device; no card
  is needed): train shapes count ``steps.make_phase_step``, the tree
  phase the reference lowers (``--phase-steps`` local steps, then the
  phase-end average), through the plain versions; every worker row does
  the same work, so one row's phase step (one local step, no average) is
  counted and scaled by the W rows and the K steps, and the average is
  counted over the W rows. Prefill counts ``make_prefill_step``
  (``impl="plain"``), decode ``make_decode_step``;
- per device: the counted flops and bytes over the chips (the
  reference's accounting), the argument and output bytes from the shard
  shapes that ``sharding/specs.py`` gives the trees;
- the collectives: what the port's sharded engine sends for the
  phase-end average (``PhaseEngine._step_psum``: one all-reduce of each
  device's share of the f32 column sums, the dispersion's scalars
  gathered; a hierarchical average also gathers the rows), sent through
  a fake worker mesh on ``meta`` tensors and read back from
  ``read_stats()``. The port runs no tensor-parallel step, so the model
  axis's activation collectives, which GSPMD inserts into the
  reference's program, are not counted: each row says so
  (``"collectives": "worker axes"``).

Run: ``PYTHONPATH=src python -m repro_torch.launch.dryrun --arch
smollm-360m --shape train_4k --mesh single`` (no card; ``--out rows.jsonl
--skip-done`` appends rows and skips those already there).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCHS, SHAPES, get_config, get_shape,
                                 long_context_variant)
from repro_torch.core.averaging import average_all, average_inner
from repro_torch.core.flat import tree_map
from repro_torch.launch import steps
from repro_torch.launch.mesh import (make_production_mesh, make_worker_mesh,
                                     worker_axes)
from repro_torch.roofline.analysis import (count_step, model_flops,
                                           roofline_report, shard_bytes,
                                           shard_numel)
from repro_torch.sharding import specs as S

#: what the collective term covers (module note)
COLLECTIVES = "worker axes"


def _axis_entry(axes: tuple):
    return axes[0] if len(axes) == 1 else tuple(axes)


def serve_batch_specs(batch_t, mesh):
    """Serving inputs: the batch dim over the data axes when divisible,
    then the first model-divisible dim over "model"."""
    daxes = tuple(a for a in mesh.axis_names if a != "model")
    dsize = math.prod(mesh.shape[a] for a in daxes)
    msize = mesh.shape["model"]

    def spec(leaf):
        dims = tuple(leaf.shape)
        entries = [None] * len(dims)
        start = 0
        if dims and dims[0] % dsize == 0 and dims[0] >= dsize:
            entries[0] = _axis_entry(daxes)
            start = 1
        for i in range(start, len(dims)):
            if dims[i] % msize == 0 and dims[i] >= msize:
                entries[i] = "model"
                break
        return S.P(*entries)

    return tree_map(spec, batch_t)


def skip_reason(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch == "whisper-small":
        return ("enc-dec audio model: no 500k-token decode configuration "
                "(DESIGN.md §4)")
    return None


@contextlib.contextmanager
def fake_group(world: int):
    """torch's ``fake`` process group of ``world`` ranks, this process
    rank 0, for the ``with`` block; destroyed on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _phase_end_collectives(mesh, wp_t, p_specs, num_workers: int,
                           avg: str, inner: int) -> dict:
    """The collectives the sharded engine sends for one phase-end
    average, sent on ``meta`` tensors through a worker mesh of the
    ``num_workers`` ranks of the worker axes; their ``read_stats()``."""
    if avg == "none":
        return {}
    share = shard_numel(wp_t, p_specs, mesh.shape)  # one row's share
    wmesh = make_worker_mesh(num_workers, backend="fake", device="meta")
    try:
        col = torch.empty((share,), dtype=torch.float32, device="meta")
        wmesh.all_reduce_(col)  # the global mean's column sums
        # the dispersion's squared distances, gathered and summed in
        # rank order (on the host, as the engine sums them)
        wmesh.sum_scalars(torch.zeros((), dtype=torch.float32))
        if avg == "inner" and inner:
            # a group mean runs on the gathered plane
            wmesh.all_gather_rows(col[None])
        return wmesh.read_stats()
    finally:
        S.set_axis_sizes(dict(mesh.shape))


def count_combo(cfg, shape, mesh, *, avg: str = "none", impl: str = "plain",
                remat: bool = True, expert_parallel: bool = False,
                cache_layout: str = "seq", phase_steps: int = 4) -> dict:
    """Count ``cfg``'s step at ``shape`` on ``mesh`` (module note).
    Returns {"counts": the whole step's StepCounts, "stats": the
    collectives' read_stats(), "argument_bytes" / "output_bytes": per
    device, "counted": what was counted}."""
    msize = mesh.shape["model"]
    ep = expert_parallel
    if shape.kind == "train":
        waxes = worker_axes(mesh)
        W = math.prod(mesh.shape[a] for a in waxes)
        wentry = _axis_entry(waxes)
        opt = steps.make_optimizer()
        wp_t, os_t = steps.abstract_worker_state(cfg, opt, W)
        batch_t = steps.input_specs(cfg, shape, num_workers=W)
        phase_batch_t = tree_map(
            lambda s: steps.sds((phase_steps,) + tuple(s.shape), s.dtype),
            batch_t)
        inner = mesh.shape["pod"] if (avg == "hier"
                                      and "pod" in mesh.axis_names) else 0
        mode = {"none": "none", "hier": "inner"}.get(avg, "all")
        p_specs = S.param_specs(wp_t, msize, worker_axes=wentry,
                                moe_expert_parallel=ep)
        o_specs = S.param_specs(os_t, msize, worker_axes=wentry,
                                moe_expert_parallel=ep)
        # batch_specs with the leading K (scan) dim unsharded
        b_specs = S.tree_specs(phase_batch_t, msize, prefix=(None, wentry),
                               rule=S.first_divisible_spec)
        state_bytes = (shard_bytes(wp_t, p_specs, mesh.shape)
                       + shard_bytes(os_t, o_specs, mesh.shape))
        arg = state_bytes + shard_bytes(phase_batch_t, b_specs,
                                        mesh.shape) + 4  # + step0 int32
        out = state_bytes + 4 * phase_steps  # + the (K,) f32 losses
        # one row's phase step: one local step, no average
        row_wp, row_os = steps.abstract_worker_state(cfg, opt, 1)
        row_batch = tree_map(
            lambda s: steps.sds((1, 1) + tuple(s.shape[1:]), s.dtype),
            batch_t)
        row_step = steps.make_phase_step(
            cfg, phase_len=1, impl=impl, remat=remat, avg="none",
            optimizer=opt, kernel_impl="ref")
        counts = count_step(row_step, row_wp, row_os, row_batch,
                            0).scaled(W * phase_steps)
        if mode != "none":
            counts = counts + count_step(
                lambda wp: (average_inner(wp, inner) if mode == "inner"
                            and inner else average_all(wp)), wp_t)
        stats = _phase_end_collectives(mesh, wp_t, p_specs, W, mode, inner)
        counted = (f"one worker row's phase step (1 local step, no average) "
                   f"x {W} rows x {phase_steps} steps"
                   + ("" if mode == "none" else
                      f", + the phase-end average over the {W} rows"))
    elif shape.kind == "prefill":
        p_t = steps.abstract_params(cfg)
        batch_t = steps.input_specs(cfg, shape)
        fn = steps.make_prefill_step(cfg, impl=impl)
        p_specs = S.param_specs(p_t, msize, moe_expert_parallel=ep)
        with torch.no_grad():
            counts = count_step(fn, p_t, batch_t)
        logits = steps.sds((shape.global_batch, cfg.padded_vocab),
                           torch.float32)
        arg = (shard_bytes(p_t, p_specs, mesh.shape)
               + shard_bytes(batch_t, serve_batch_specs(batch_t, mesh),
                             mesh.shape))
        out = shard_bytes(logits, serve_batch_specs(logits, mesh),
                          mesh.shape)
        stats, counted = {}, "the prefill step"
    else:  # decode
        p_t = steps.abstract_params(cfg)
        batch_t = steps.input_specs(cfg, shape)
        cache_t = steps.abstract_cache(cfg, shape)
        fn = steps.make_decode_step(cfg)
        p_specs = S.param_specs(p_t, msize, moe_expert_parallel=ep)
        daxes = tuple(a for a in mesh.axis_names if a != "model")
        # "pos" is the Python int the port's decode indexes with
        layers = {"layers": cache_t["layers"]}
        c_specs = S.cache_specs(layers, msize, data_axes=_axis_entry(daxes),
                                long_layout=cache_layout)
        tok = batch_t["tokens"]
        with torch.no_grad():
            counts = count_step(fn, p_t, tok, cache_t)
        cache = shard_bytes(layers, c_specs, mesh.shape)
        logits = steps.sds((shape.global_batch, 1, cfg.padded_vocab),
                           torch.float32)
        arg = (shard_bytes(p_t, p_specs, mesh.shape) + cache
               + shard_bytes(tok, serve_batch_specs(tok, mesh), mesh.shape))
        out = cache + shard_bytes(logits, serve_batch_specs(logits, mesh),
                                  mesh.shape)
        stats, counted = {}, "the decode step"
    return {"counts": counts, "stats": stats, "argument_bytes": arg,
            "output_bytes": out, "counted": counted}


def _variant(*, banded, score_bf16, cache_layout, expert_parallel,
             moe_group, remat) -> str:
    return "+".join(filter(None, [
        "banded" if banded else "", "bf16scores" if score_bf16 else "",
        f"cache-{cache_layout}" if cache_layout != "seq" else "",
        "ep" if expert_parallel else "",
        f"moegroup{moe_group}" if moe_group else "",
        "" if remat else "no-remat"])) or "baseline"


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool,
                avg: str = "none", impl: str = "plain", remat: bool = True,
                expert_parallel: bool = False, banded: bool = False,
                score_bf16: bool = False, cache_layout: str = "seq",
                moe_group: int = 0, phase_steps: int = 4,
                verbose: bool = True):
    """Count one (arch x shape x mesh) combination: it counts where the
    reference lowers and compiles (module note), on the production mesh
    over a fake group of 256 or 512 ranks. Returns (counted, meta):
    :func:`count_combo`'s dict (None when skipped) and the row's
    keys."""
    reason = skip_reason(arch, shape_name)
    if reason:
        return None, {"skipped": reason}
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape_name == "long_500k":
        cfg = long_context_variant(cfg)
    if banded:
        cfg = dataclasses.replace(cfg, attn_banded=True)
    if score_bf16:
        cfg = dataclasses.replace(cfg, score_dtype="bfloat16")
    if moe_group:
        cfg = dataclasses.replace(cfg, moe_group_size=moe_group)

    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, backend="fake",
                                    device="meta")
        chips = mesh.size
        t0 = time.perf_counter()
        counted = count_combo(cfg, shape, mesh, avg=avg, impl=impl,
                              remat=remat, expert_parallel=expert_parallel,
                              cache_layout=cache_layout,
                              phase_steps=phase_steps)
        count_s = time.perf_counter() - t0

    flops = model_flops(cfg, shape, training=shape.kind == "train")
    if shape.kind == "train":
        flops *= phase_steps  # the counted program is a whole phase
    meta = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "avg": avg, "chips": chips,
        "phase_steps": phase_steps if shape.kind == "train" else 0,
        "count_s": round(count_s, 1),
        "model_flops": flops,
        "expert_parallel": expert_parallel,
        "variant": _variant(banded=banded, score_bf16=score_bf16,
                            cache_layout=cache_layout,
                            expert_parallel=expert_parallel,
                            moe_group=moe_group, remat=remat),
        "counted": counted["counted"],
        "ops": counted["counts"].ops,
        "collectives": COLLECTIVES,
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {meta['mesh']} avg={avg} "
              f"count={count_s:.1f}s", flush=True)
    return counted, meta


def run_one(arch, shape_name, *, multi_pod, avg="none",
            expert_parallel=False, banded=False, score_bf16=False,
            cache_layout="seq", remat=True, moe_group=0, phase_steps=4,
            verbose=True):
    counted, meta = lower_combo(
        arch, shape_name, multi_pod=multi_pod, avg=avg,
        expert_parallel=expert_parallel, banded=banded,
        score_bf16=score_bf16, cache_layout=cache_layout, remat=remat,
        moe_group=moe_group, phase_steps=phase_steps, verbose=verbose)
    if counted is None:
        return meta
    rep = roofline_report(counted["counts"], model_flops=meta["model_flops"],
                          chips=meta["chips"], stats=counted["stats"],
                          argument_bytes_per_device=counted["argument_bytes"],
                          output_bytes_per_device=counted["output_bytes"])
    meta.update(rep)
    if verbose:
        print("         memory (shard shapes): " +
              ", ".join(f"{k.removeprefix('mem_')}={v / 2**30:.2f}GiB"
                        for k, v in meta.items() if k.startswith("mem_")),
              flush=True)
        print(f"         flops/dev={rep['flops_per_device']:.3e} "
              f"bytes/dev={rep['bytes_per_device']:.3e} "
              f"coll/dev={rep['collective_bytes_per_device']:.3e} "
              f"bottleneck={rep['bottleneck']}", flush=True)
    return meta


def _done_keys(path: str) -> set:
    """The (arch, shape, mesh, avg, variant) keys of the rows in
    ``path``; lines that are not such rows are passed over."""
    done = set()
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"],
                          r.get("avg", "none"), r.get("variant", "baseline")))
            except (json.JSONDecodeError, KeyError, TypeError):
                pass
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-pod dry run: each step counted on meta tensors "
                    "over a fake process group (no card)")
    ap.add_argument("--arch", default=None, choices=ARCHS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--avg", default="none", choices=["none", "all", "hier"])
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--banded", action="store_true",
                    help="banded sliding-window attention (perf variant)")
    ap.add_argument("--score-bf16", action="store_true",
                    help="bf16 attention score traffic (perf variant)")
    ap.add_argument("--cache-layout", default="seq",
                    choices=["seq", "heads"],
                    help="long-context decode cache layout (perf variant)")
    ap.add_argument("--moe-group", type=int, default=0,
                    help="MoE dispatch group size (perf variant; 0 = "
                         "global capacity baseline)")
    ap.add_argument("--phase-steps", type=int, default=4,
                    help="local steps per averaging phase for train "
                         "shapes (the engine's K)")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable per-block remat (noted in the row's "
                         "variant)")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    variant = _variant(banded=args.banded, score_bf16=args.score_bf16,
                       cache_layout=args.cache_layout,
                       expert_parallel=args.expert_parallel,
                       moe_group=args.moe_group, remat=not args.no_remat)
    done = set()
    if args.out and args.skip_done and os.path.exists(args.out):
        done = _done_keys(args.out)

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                key = (arch, shape_name, mesh_name, args.avg, variant)
                if key in done:
                    continue
                try:
                    meta = run_one(arch, shape_name, multi_pod=mp,
                                   avg=args.avg,
                                   expert_parallel=args.expert_parallel,
                                   banded=args.banded,
                                   score_bf16=args.score_bf16,
                                   cache_layout=args.cache_layout,
                                   remat=not args.no_remat,
                                   moe_group=args.moe_group,
                                   phase_steps=args.phase_steps)
                except Exception as e:  # a failure here is a bug — surface it
                    failures.append((key, repr(e)))
                    traceback.print_exc()
                    print(f"[dryrun] FAIL {key}: {e!r}", flush=True)
                    continue
                if args.out:
                    meta.setdefault("arch", arch)
                    meta.setdefault("shape", shape_name)
                    meta.setdefault("mesh", mesh_name)
                    meta.setdefault("avg", args.avg)
                    meta.setdefault("variant", variant)
                    with open(args.out, "a") as f:
                        f.write(json.dumps(meta) + "\n")
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES", flush=True)
        sys.exit(1)
    print("[dryrun] all combinations counted OK", flush=True)


if __name__ == "__main__":
    main()
