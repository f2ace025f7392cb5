"""The port's dry run (``repro_torch.launch.dryrun``) and what it reads
(the configs' shape machinery, ``launch/steps.py``'s abstract inputs)
against the reference's on the CPU.

- ``SHAPES`` / ``get_shape``, ``long_context_variant`` and
  ``supports_long_decode`` equal to the reference's for the ten archs;
  ``input_specs`` for ten archs x four shapes (16 workers on train
  shapes) in keys, shapes and dtypes; ``skip_reason`` for the 40 pairs;
- ``abstract_params`` of the ten archs at full width, leaf by leaf in
  the layout ``convert.params_from_jax`` maps, equal in shapes and dtypes
  to the reference's ``jax.eval_shape`` tree; all ten in under 20 s and
  without one threefry draw; ``abstract_worker_state`` and
  ``abstract_cache`` the same on the reduced configs and at full width
  for smollm-360m and whisper-small;
- the collective term and the argument bytes on the reference's
  ``MINI_DRYRUN`` mesh (data 2, model 2, pod 2: W = 4) over a fake group
  of 8 in a subprocess (so that no process group outlives it);
- the CLI in subprocesses: smollm-360m over four shapes on both meshes,
  whisper-small x long_500k skipped with the reference's reason,
  phi3.5-moe with ``--expert-parallel --moe-group``, ``--out`` /
  ``--skip-done`` repeating no row, a bad flag exiting 2.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.sharding import specs as JS  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch import rng  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
ARCHS = jconfigs.ARCHS
SHAPES = list(jconfigs.SHAPES)
#: a small decode shape for the reduced configs' caches
SMALL_DECODE = ("d", "decode", 64, 2)


def _layout(tree):
    """Nested dicts / lists of (shape, dtype name), for jax and torch
    trees alike."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_layout(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in pconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for name in SHAPES:
        assert dataclasses.asdict(pconfigs.get_shape(name)) \
            == dataclasses.asdict(jconfigs.get_shape(name))
    with pytest.raises(KeyError):
        pconfigs.get_shape("train_8k")


@pytest.mark.parametrize("arch", ARCHS)
def test_long_context_variant_matches_reference(arch):
    for reduced in (False, True):
        p = pconfigs.get_config(arch, reduced=reduced)
        j = jconfigs.get_config(arch, reduced=reduced)
        assert p.supports_long_decode() == j.supports_long_decode()
        pv, jv = (pconfigs.long_context_variant(p),
                  jconfigs.long_context_variant(j))
        assert dataclasses.asdict(pv) == dataclasses.asdict(jv)
        assert pv.supports_long_decode() == jv.supports_long_decode()
        assert (pv is p) == (jv is j)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    p, j = pconfigs.get_config(arch), jconfigs.get_config(arch)
    ps, js = pconfigs.SHAPES[shape], jconfigs.SHAPES[shape]
    kw = {"num_workers": 16} if ps.kind == "train" else {}
    got = steps.input_specs(p, ps, **kw)
    want = jsteps.input_specs(j, js, **kw)
    assert all(t.device.type == "meta" for t in got.values())
    assert _layout(got) == _layout(want)
    assert dryrun.skip_reason(arch, shape) == \
        jdryrun_skip_reason(arch, shape)


def jdryrun_skip_reason(arch, shape):
    """The reference's ``skip_reason``. Its module sets XLA's device
    count when imported first: read the function from its source instead
    of importing ``repro.launch.dryrun`` into this process again."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    body = src[src.index("def skip_reason"):src.index("def lower_combo")]
    ns = {}
    exec(body, ns)
    return ns["skip_reason"](arch, shape)


def test_input_specs_refuse_workers_as_the_reference():
    p, j = pconfigs.get_config("smollm-360m"), jconfigs.get_config(
        "smollm-360m")
    for n in (0, 3):
        with pytest.raises(AssertionError):
            jsteps.input_specs(j, jconfigs.SHAPES["train_4k"],
                               num_workers=n)
        with pytest.raises(ValueError, match="num_workers"):
            steps.input_specs(p, pconfigs.SHAPES["train_4k"], num_workers=n)


def _only_python_ints(fn):
    """``fn`` (the threefry hash) refusing tensors of counters: a key
    split hashes Python ints on the host; a draw hashes a tensor."""
    def wrapped(k1, k2, x1, x2):
        if isinstance(x1, torch.Tensor) or isinstance(x2, torch.Tensor):
            raise AssertionError("a draw hashed a tensor of counters")
        return fn(k1, k2, x1, x2)
    return wrapped


@pytest.fixture(scope="module")
def full_params():
    """abstract_params of every arch at full width, built while a draw
    would raise, and the seconds it took."""
    orig = rng.threefry2x32
    rng.threefry2x32 = _only_python_ints(orig)
    try:
        t0 = time.perf_counter()
        trees = {a: steps.abstract_params(pconfigs.get_config(a))
                 for a in ARCHS}
        secs = time.perf_counter() - t0
    finally:
        rng.threefry2x32 = orig
    return trees, secs


def test_abstract_params_all_archs_fast_and_on_meta(full_params):
    trees, secs = full_params
    assert secs < 20.0, secs
    for t in trees.values():
        leaves = jax.tree.leaves(t, is_leaf=lambda x: isinstance(
            x, torch.Tensor))
        assert leaves and all(x.device.type == "meta" for x in leaves)


def test_init_params_still_draws_off_meta():
    cfg = pconfigs.get_config("smollm-360m", reduced=True)
    orig = rng.threefry2x32
    rng.threefry2x32 = _only_python_ints(orig)
    try:
        with pytest.raises(AssertionError, match="hashed a tensor"):
            steps.tfm.init_params(cfg, 0, device="cpu")
    finally:
        rng.threefry2x32 = orig


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch, full_params):
    trees, _ = full_params
    want = jsteps.abstract_params(jconfigs.get_config(arch))
    assert _layout(trees[arch]) == _layout(want)


def _worker_state_layouts(arch, reduced, workers=4):
    p, j = (pconfigs.get_config(arch, reduced=reduced),
            jconfigs.get_config(arch, reduced=reduced))
    got = steps.abstract_worker_state(p, steps.make_optimizer(), workers)
    want = jsteps.abstract_worker_state(j, jsteps.make_optimizer(), workers)
    return _layout(got), _layout(want)


def _cache_layouts(arch, reduced, shape):
    p, j = (pconfigs.get_config(arch, reduced=reduced),
            jconfigs.get_config(arch, reduced=reduced))
    got = steps.abstract_cache(p, pconfigs.ShapeConfig(*shape))
    want = jsteps.abstract_cache(j, jconfigs.ShapeConfig(*shape))
    assert got["pos"] == 0 and want["pos"].shape == ()
    return _layout(got["layers"]), _layout(want["layers"])


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_worker_state_and_cache_match_reference_reduced(arch):
    got, want = _worker_state_layouts(arch, True)
    assert got == want
    got, want = _cache_layouts(arch, True, SMALL_DECODE)
    assert got == want


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-small"])
def test_abstract_worker_state_and_cache_match_reference_full(arch):
    got, want = _worker_state_layouts(arch, False, workers=16)
    assert got == want
    got, want = _cache_layouts(arch, False, ("decode_32k", "decode", 32768,
                                             128))
    assert got == want


# ---- the collectives and argument bytes on the MINI_DRYRUN mesh ----------

MINI = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.roofline.analysis import roofline_report

    cfg = get_config("smollm-360m", reduced=True)
    shape = ShapeConfig("t", "train", 64, 8)        # 8 seqs of 64
    rows = {}
    with dryrun.fake_group(8):
        mesh = make_host_mesh(data=2, model=2, pod=2, backend="fake",
                              device="meta")          # 8 fake ranks
        for avg in ("all", "none", "hier"):
            c = dryrun.count_combo(cfg, shape, mesh, avg=avg,
                                   phase_steps=2)
            rep = roofline_report(
                c["counts"], chips=8, stats=c["stats"],
                argument_bytes_per_device=c["argument_bytes"],
                output_bytes_per_device=c["output_bytes"])
            rows[avg] = {k: v for k, v in rep.items()
                         if isinstance(v, (int, float, str, dict))}
    rows["initialized_after"] = dist.is_initialized()
    print(json.dumps(rows))
""")


@pytest.fixture(scope="module")
def mini_rows():
    out = subprocess.run([sys.executable, "-c", MINI], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _ref_shard_bytes(tree, specs, sizes):
    """Bytes a device holds under the reference's specs."""
    leaves = jax.tree.leaves(tree)
    sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    total = 0
    for x, s in zip(leaves, sp, strict=True):
        div = 1
        for e in s:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    div *= sizes[a]
        n = math.prod(x.shape)
        total += -(-n // div) * x.dtype.itemsize
    return total


def test_mini_dryrun_collectives(mini_rows):
    assert mini_rows["initialized_after"] is False
    assert mini_rows["all"]["collective_bytes_per_device"] > 0
    assert mini_rows["all"]["collective_counts"]["all_reduce"] == 1
    assert mini_rows["none"]["collective_bytes_per_device"] == 0
    # a hierarchical average over the pods gathers the rows as well
    assert mini_rows["hier"]["collective_counts"]["all_gather"] == 2
    # the average adds bytes, and no matmul flops
    assert (mini_rows["all"]["bytes_per_device"]
            > mini_rows["none"]["bytes_per_device"] > 0)
    assert (mini_rows["all"]["flops_per_device"]
            == mini_rows["none"]["flops_per_device"] > 0)


def test_mini_dryrun_argument_bytes_match_reference_specs(mini_rows):
    sizes = {"pod": 2, "data": 2, "model": 2}
    cfg = jconfigs.get_config("smollm-360m", reduced=True)
    shape = jconfigs.ShapeConfig("t", "train", 64, 8)
    went, W, K = ("pod", "data"), 4, 2
    wp, os_ = jsteps.abstract_worker_state(cfg, jsteps.make_optimizer(), W)
    batch = jsteps.input_specs(cfg, shape, num_workers=W)
    pbatch = jax.tree.map(lambda s: jsteps.sds((K,) + s.shape, s.dtype),
                          batch)
    P = jax.sharding.PartitionSpec
    state = (_ref_shard_bytes(wp, JS.param_specs(wp, 2, worker_axes=went),
                              sizes)
             + _ref_shard_bytes(os_, JS.param_specs(os_, 2,
                                                    worker_axes=went),
                                sizes))
    bspecs = jax.tree.map(lambda sp: P(None, *sp),
                          JS.batch_specs(batch, 2, worker_axes=went),
                          is_leaf=lambda x: isinstance(x, P))
    want = state + _ref_shard_bytes(pbatch, bspecs, sizes) + 4  # + step
    for avg in ("all", "none", "hier"):
        assert mini_rows[avg]["mem_argument_size_in_bytes"] == want
        assert mini_rows[avg]["mem_output_size_in_bytes"] == state + 4 * K
    # the all-reduce carries one row's share of the f32 column sums
    row_share = sum(-(-math.prod(x.shape) // (W * (
        2 if any(e == "model" for e in s) else 1)))
        for x, s in zip(jax.tree.leaves(wp), jax.tree.leaves(
            JS.param_specs(wp, 2, worker_axes=went),
            is_leaf=lambda x: isinstance(x, P))))
    assert mini_rows["all"]["collective_breakdown"]["all_reduce"] \
        == 4 * row_share


# ---- the CLI -------------------------------------------------------------

def _cli(*argv, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv], env=ENV,
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


ROW_KEYS = {"arch", "shape", "mesh", "avg", "chips", "phase_steps",
            "count_s", "model_flops", "expert_parallel", "variant",
            "collectives", "flops_per_device", "bytes_per_device", "wire",
            "collective_bytes_per_device", "compute_s", "memory_s",
            "collective_s", "bottleneck", "step_time_lower_bound_s",
            "useful_flop_fraction", "mem_argument_size_in_bytes",
            "mem_output_size_in_bytes"}


@pytest.fixture(scope="module")
def smollm_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "rows.jsonl"
    run = _cli("--arch", "smollm-360m", "--mesh", "both", "--out", str(out))
    assert run.returncode == 0, run.stderr[-3000:] + run.stdout[-3000:]
    assert "[dryrun] all combinations counted OK" in run.stdout
    return out, [json.loads(ln) for ln in out.read_text().splitlines()]


def test_cli_writes_a_row_per_shape_and_mesh(smollm_rows):
    _, rows = smollm_rows
    assert [(r["shape"], r["mesh"]) for r in rows] == [
        (s, m) for s in SHAPES for m in ("16x16", "2x16x16")]
    for r in rows:
        assert ROW_KEYS <= set(r), ROW_KEYS - set(r)
        assert "lower_s" not in r and "compile_s" not in r
        assert r["collectives"] == "worker axes"
        assert r["chips"] == (512 if r["mesh"] == "2x16x16" else 256)
        assert r["variant"] == "baseline" and r["avg"] == "none"
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert r["collective_bytes_per_device"] == 0  # --avg none
        shape = jconfigs.SHAPES[r["shape"]]
        cfg = jconfigs.get_config("smollm-360m")
        if r["shape"] == "long_500k":
            cfg = jconfigs.long_context_variant(cfg)
        from repro.roofline.analysis import model_flops as jmf
        want = jmf(cfg, shape, training=shape.kind == "train")
        assert r["model_flops"] == want * (4 if shape.kind == "train" else 1)
    train = {r["mesh"]: r for r in rows if r["shape"] == "train_4k"}
    # twice the chips, the same global step: half the work a device
    np.testing.assert_allclose(train["2x16x16"]["flops_per_device"] * 2,
                               train["16x16"]["flops_per_device"],
                               rtol=1e-9)


def test_cli_skip_done_repeats_no_row(smollm_rows):
    out, rows = smollm_rows
    run = _cli("--arch", "smollm-360m", "--mesh", "both", "--out", str(out),
               "--skip-done")
    assert run.returncode == 0, run.stderr[-3000:]
    assert "[dryrun] smollm-360m" not in run.stdout
    assert len(out.read_text().splitlines()) == len(rows)


def test_cli_skips_whisper_long_context_and_counts_phi_moe(tmp_path):
    out = tmp_path / "rows.jsonl"
    run = _cli("--arch", "whisper-small", "--shape", "long_500k", "--out",
               str(out))
    assert run.returncode == 0, run.stderr[-3000:]
    run = _cli("--arch", "phi3.5-moe-42b-a6.6b", "--shape", "decode_32k",
               "--expert-parallel", "--moe-group", "256", "--out", str(out))
    assert run.returncode == 0, run.stderr[-3000:]
    skip, phi = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert skip["skipped"] == jdryrun_skip_reason("whisper-small",
                                                  "long_500k")
    assert (skip["arch"], skip["shape"]) == ("whisper-small", "long_500k")
    assert phi["variant"] == "ep+moegroup256" and phi["expert_parallel"]
    assert ROW_KEYS <= set(phi)


def test_cli_refuses_a_bad_flag():
    run = _cli("--arch", "smollm-360m", "--mesh", "triple", timeout=120)
    assert run.returncode == 2
    assert "invalid choice" in run.stderr


def test_cli_counts_a_failure_and_exits_one(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(dryrun, "run_one", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-360m", "--shape", "train_4k"])
    assert e.value.code == 1
    out = capsys.readouterr()
    assert "[dryrun] FAIL ('smollm-360m', 'train_4k', '16x16'" in out.out
    assert "[dryrun] 1 FAILURES" in out.out
    assert "RuntimeError: boom" in out.err
    assert not torch.distributed.is_initialized()
