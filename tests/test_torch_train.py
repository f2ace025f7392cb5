"""The port's training CLI on the CPU (its fault, elastic and checkpoint
flags against the reference's CLI), the port's import isolation from
JAX, and ``chip_smoke.py``'s refusal to run without a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_cli_trains_on_cpu(capsys):
    final, hist, state = train.main(
        ["--device", "cpu", "--reduced", "--steps", "6", "--workers", "4",
         "--avg", "periodic", "--phase-len", "3", "--batch", "2",
         "--seq", "16"])
    out = capsys.readouterr().out
    assert "[train] smollm-360m-reduced:" in out
    assert "[train] 6 steps in" in out
    assert "2 averaging ops" in out
    assert hist["averages"] == 2
    assert state.step == 6 and state.plane.shape[0] == 4
    assert all(torch.isfinite(x).all() for x in
               torch.utils._pytree.tree_leaves(final))


def test_cli_hierarchical_on_cpu(capsys):
    _, hist, _ = train.main(
        ["--device", "cpu", "--reduced", "--steps", "4", "--workers", "4",
         "--avg", "hierarchical", "--phase-len", "1",
         "--outer-phase-len", "4", "--inner-groups", "2", "--batch", "1",
         "--seq", "8"])
    assert hist["averages"] == 4
    assert [t for t, _ in hist["dispersion"]] == [1, 2, 3, 4]


@pytest.mark.parametrize("argv", [
    ["--avg", "hierarchical", "--inner-groups", "3"],
    ["--avg", "hierarchical", "--phase-len", "8", "--outer-phase-len", "8"],
    ["--avg", "adaptive_threshold"],
    ["--avg", "adaptive_budget"],
    ["--avg", "stochastic", "--zeta", "0"],
    ["--avg", "adaptive_bytes"],
])
def test_cli_refuses_bad_flags(argv):
    with pytest.raises(SystemExit) as e:
        train.main(["--reduced", "--steps", "2"] + argv)
    assert e.value.code == 2


@pytest.mark.parametrize("argv,why", [
    (["--avg", "stochastic", "--zeta", "1.5"], "--zeta"),
    (["--comm-dtype", "int8", "--no-error-feedback"], "error-feedback"),
    (["--comm-dtype", "one_bit", "--no-error-feedback"], "error-feedback"),
    (["--outer-momentum", "0.5", "--comm-dtype", "bf16"], "consensus"),
    (["--outer-momentum", "0.5", "--topology", "ring"], "consensus"),
    (["--topology", "ring", "--workers", "2"], ">= 3 workers"),
    (["--topology", "torus", "--workers", "5"], "composite"),
    (["--topology", "hypercube", "--workers", "6"], "power-of-two"),
    (["--topology", "gossip_pairs", "--workers", "3"], "even count"),
    (["--topology", "groups", "--topology-groups", "3"], "dividing"),
    (["--avg", "adaptive_bytes", "--byte-budget", "100"], "below the cost"),
    (["--kernel-impl", "cuda"], "--kernel-impl cuda"),
], ids=lambda v: "-".join(v) if isinstance(v, list) else None)
def test_cli_refuses_bad_communication_flags(argv, why, capsys):
    """The reference's parse-time refusals of the topology, wire and
    outer-optimizer flags, each with its reason, before any training."""
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--reduced", "--steps", "2"] + argv)
    assert e.value.code == 2
    assert why in capsys.readouterr().err


@pytest.mark.parametrize("argv,events,line", [
    (["--avg", "periodic", "--phase-len", "2", "--topology", "ring"], 2,
     "[train] topology=ring (spectral gap 0.667, 2.0 msgs/worker/event)"),
    (["--avg", "minibatch", "--topology", "gossip_pairs", "--comm-dtype",
      "int8"], 4, "[train] wire=int8 (error_feedback=True)"),
    (["--avg", "stochastic", "--zeta", "0.5", "--comm-dtype", "one_bit"],
     None, "[train] wire=one_bit (error_feedback=True)"),
    (["--avg", "periodic", "--phase-len", "2", "--outer-momentum", "0.5"],
     2, "2 averaging ops"),
    (["--avg", "adaptive_bytes", "--byte-budget", "100000000",
      "--comm-dtype", "bf16", "--no-error-feedback"], None,
     "[train] wire=bf16 (error_feedback=False)"),
], ids=["ring", "gossip-int8-mb", "stochastic-1bit", "outer", "bytes-bf16"])
def test_cli_communication_flags_train_on_cpu(argv, events, line, capsys):
    final, hist, state = train.main(
        ["--device", "cpu", "--reduced", "--steps", "4", "--workers", "4",
         "--batch", "1", "--seq", "8"] + argv)
    assert line in capsys.readouterr().out
    if events is not None:
        assert hist["averages"] == events
    assert all(torch.isfinite(x).all() for x in
               torch.utils._pytree.tree_leaves(final))
    assert (state.resid is not None) == ("--comm-dtype" in argv)
    assert (state.outer_state != ()) == ("--outer-momentum" in argv)


FAULT_ARGV = ["--reduced", "--steps", "6", "--workers", "4", "--avg",
              "periodic", "--phase-len", "2", "--batch", "1", "--seq", "8",
              "--faults", "crash:m=1@t=3,rejoin:m=1@t=5",
              "--straggle-prob", "0.2"]


@pytest.mark.parametrize("extra", [[], ["--rejoin-curriculum", "1"]],
                         ids=["plan", "curriculum"])
def test_cli_faults_train_on_cpu_as_the_reference(extra, capsys):
    """A crash, a rejoin and stragglers: the port's CLI trains and reports
    the reference CLI's fault line and averaging count."""
    from repro.launch import train as jtrain
    jtrain.main(FAULT_ARGV + extra)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if "faults:" in ln or "averaging ops" in ln]
    final, hist, state = train.main(["--device", "cpu"] + FAULT_ARGV + extra)
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if "faults:" in ln or "averaging ops" in ln]
    assert got[0] == want[0] == ("[train] faults: 1 crash / 1 rejoin "
                                 "events, straggle_prob=0.2")
    assert got[1].split("), ")[1] == want[1].split("), ")[1] == \
        "3 averaging ops"
    assert state.fault.alive.tolist() == [1.0] * 4
    assert all(torch.isfinite(x).all() for x in
               torch.utils._pytree.tree_leaves(final))


@pytest.mark.parametrize("argv,why", [
    (["--rejoin", "5"], "--rejoin without --faults"),
    (["--avg", "periodic", "--straggle-aware", "--straggle-prob", "0.1"],
     "never consumes dispersion"),
    (["--avg", "adaptive_threshold", "--disp-threshold", "0.1",
      "--straggle-aware", "--faults", "crash:m=1@t=2"],
     "--straggle-prob > 0"),
    (["--faults", "crash:m=1@t=2", "--outer-momentum", "0.5"],
     "full-membership"),
    (["--faults", "crash:m=9@t=2"], "out of range"),
    (["--faults", "crash m=1"], "cannot parse"),
    (["--straggle-prob", "1.5"], "[0, 1]"),
    (["--faults", "crash:m=1@t=2", "--rejoin-curriculum", "2"],
     "curriculum"),
    (["--non-iid-alpha", "-1"], "--non-iid-alpha"),
], ids=["rejoin", "aware-static", "aware-no-stragglers", "outer", "row",
        "syntax", "prob", "curriculum", "alpha"])
def test_cli_refuses_bad_fault_flags_as_the_reference(argv, why, capsys):
    """The reference's parse-time refusals of the fault flags: both CLIs
    exit 2 with the reason, before any training."""
    from repro.launch import train as jtrain
    base = ["--reduced", "--steps", "2"]
    with pytest.raises(SystemExit) as ej:
        jtrain.main(base + argv)
    assert ej.value.code == 2
    assert why in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu"] + base + argv)
    assert e.value.code == 2
    assert why in capsys.readouterr().err


ELASTIC_ARGV = ["--reduced", "--workers", "4", "--avg", "periodic",
                "--phase-len", "2", "--batch", "1", "--seq", "8",
                "--shrink-at", "3:2", "--grow-at", "5:4",
                "--rejoin-curriculum", "1"]


def test_cli_elastic_prints_the_reference_resize_lines(capsys):
    """``--shrink-at`` / ``--grow-at``: both CLIs print the same resize
    lines and averaging count; the port's plane is back at 4 rows."""
    from repro.launch import train as jtrain

    def lines(out):
        return [ln for ln in out.splitlines() if " workers before step "
                in ln or "averaging ops" in ln]
    jtrain.main(ELASTIC_ARGV + ["--steps", "8"])
    want = lines(capsys.readouterr().out)
    _, hist, state = train.main(["--device", "cpu", "--steps", "8"]
                                + ELASTIC_ARGV)
    got = lines(capsys.readouterr().out)
    assert got[:2] == want[:2] == [
        "[train] shrink 4 -> 2 workers before step 3",
        "[train] grow 2 -> 4 workers before step 5"]
    assert got[2].split("), ")[1] == want[2].split("), ")[1]
    assert hist["resizes"] == [(3, 4, 2), (5, 2, 4)]
    assert state.plane.shape[0] == 4


@pytest.mark.parametrize("extra", [[], ELASTIC_ARGV[-6:]],
                         ids=["fixed", "elastic"])
@pytest.mark.parametrize("cut", [2, 4])
def test_cli_checkpoint_then_resume_equals_one_run(tmp_path, capsys, cut,
                                                   extra):
    """``--checkpoint`` then ``--resume`` for the remaining steps: the
    same plane, state planes, consensus, events and losses as one run of
    all the steps (each row's stream skips the batches it took)."""
    base = ["--device", "cpu", "--reduced", "--workers", "4", "--avg",
            "periodic", "--phase-len", "2", "--batch", "1", "--seq", "8",
            "--comm-dtype", "bf16"] + extra
    f_full, h_full, s_full = train.main(base + ["--steps", "8"])
    ck = str(tmp_path / "run")
    f1, h1, _ = train.main(base + ["--steps", str(cut), "--checkpoint", ck])
    out = capsys.readouterr().out
    assert f"saved consensus model to {ck}" in out
    meta = json.load(open(ck + ".state.json"))["extra"]
    assert meta["engine_state_version"] == (5 if extra else 3)
    f2, h2, s2 = train.main(base + ["--steps", str(8 - cut), "--resume",
                                    ck + ".state"])
    assert f"resuming from {ck}.state at step {cut}" in \
        capsys.readouterr().out
    assert torch.equal(s2.plane, s_full.plane)
    assert torch.equal(s2.resid, s_full.resid)
    assert all(torch.equal(a, b) for a, b in zip(s2.opt_planes,
                                                 s_full.opt_planes))
    for a, b in zip(torch.utils._pytree.tree_leaves(f2),
                    torch.utils._pytree.tree_leaves(f_full)):
        assert torch.equal(a, b)
    assert h1["averages"] + h2["averages"] == h_full["averages"]
    assert h1["dispersion"] + h2["dispersion"] == h_full["dispersion"]
    # the consensus model file holds the first run's final consensus
    from repro_torch.checkpoint import load_checkpoint
    back, step = load_checkpoint(ck, f1)
    assert step == cut
    for a, b in zip(torch.utils._pytree.tree_leaves(back),
                    torch.utils._pytree.tree_leaves(f1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("argv,why", [
    (["--shrink-at", "bogus"], "cannot parse"),
    (["--workers", "4", "--shrink-at", "8:6"], "would grow"),
    (["--workers", "4", "--grow-at", "8:2"], "would shrink"),
    (["--workers", "4", "--shrink-at", "8:3", "--grow-at", "8:4"],
     "strictly increasing"),
    (["--workers", "4", "--shrink-at", "8:3", "--outer-momentum", "0.5"],
     "fixed-membership"),
    (["--workers", "4", "--shrink-at", "8:3", "--avg", "hierarchical",
      "--phase-len", "4", "--outer-phase-len", "8", "--inner-groups", "2"],
     "not divisible"),
    (["--workers", "4", "--shrink-at", "8:2", "--topology", "ring"],
     "incompatible with --topology ring"),
    (["--workers", "4", "--rejoin-curriculum", "3"],
     "without --grow-at or a rejoin"),
], ids=["syntax", "shrink-grows", "grow-shrinks", "same-step", "outer",
        "hierarchical", "ring", "curriculum"])
def test_cli_refuses_bad_elastic_flags_as_the_reference(argv, why, capsys):
    from repro.launch import train as jtrain
    base = ["--reduced", "--steps", "2"]
    with pytest.raises(SystemExit) as ej:
        jtrain.main(base + argv)
    assert ej.value.code == 2
    assert why in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu"] + base + argv)
    assert e.value.code == 2
    assert why in capsys.readouterr().err


def test_cli_rejoin_curriculum_accepts_a_grow(capsys):
    _, hist, _ = train.main(["--device", "cpu", "--reduced", "--steps", "4",
                             "--workers", "2", "--avg", "periodic",
                             "--phase-len", "2", "--batch", "1", "--seq",
                             "8", "--grow-at", "3:3",
                             "--rejoin-curriculum", "1"])
    assert hist["resizes"] == [(3, 2, 3)]
    assert "[train] grow 2 -> 3 workers before step 3" in \
        capsys.readouterr().out


def test_cli_kernel_impl_and_prefetch_leave_the_run_unchanged():
    """``--kernel-impl ref`` (the plain versions, which the CPU takes
    anyway) and ``--no-prefetch`` (in-line staging) train bitwise as the
    defaults do."""
    argv = ["--device", "cpu", "--reduced", "--steps", "4", "--workers",
            "2", "--avg", "periodic", "--phase-len", "2", "--batch", "1",
            "--seq", "8"]
    runs = [train.main(argv + extra) for extra in
            ([], ["--no-prefetch"], ["--kernel-impl", "ref"])]
    base_final, base_hist, _ = runs[0]
    for final, hist, _ in runs[1:]:
        for a, b in zip(torch.utils._pytree.tree_leaves(final),
                        torch.utils._pytree.tree_leaves(base_final)):
            assert torch.equal(a, b)
        assert hist["loss"] == base_hist["loss"]
        assert hist["dispersion"] == base_hist["dispersion"]


# ---- --shard: the worker rows over torchrun's ranks -------------------------

SHARD_ARGV = ["--device", "cpu", "--reduced", "--workers", "4", "--avg",
              "periodic", "--phase-len", "3", "--batch", "1", "--seq", "8"]


def _states_equal(a: str, b: str) -> bool:
    """Two engine-state checkpoints hold the same leaves, bit for bit."""
    import numpy as np
    x, y = np.load(a + ".state.npz"), np.load(b + ".state.npz")
    return x.files == y.files and all(np.array_equal(x[k], y[k])
                                      for k in x.files)


def _line(out: str, key: str) -> str:
    return next(ln for ln in out.splitlines() if key in ln)


@pytest.mark.parametrize("coll", ["gather", "psum"])
def test_cli_shard_over_two_ranks_keeps_the_run(tmp_path, capsys, coll):
    """``torchrun --nproc-per-node 2 ... --shard``: rank 0 prints the
    reference's sharding line (with the backend), the unsharded run's
    averaging count and loss line; ``gather`` checkpoints the unsharded
    run's state bit for bit."""
    import torch_sharded_worker as tw
    argv = SHARD_ARGV + ["--steps", "10", "--faults",
                         "crash:m=1@t=4,rejoin:m=1@t=7", "--straggle-prob",
                         "0.2"]
    train.main(argv + ["--checkpoint", str(tmp_path / "one")])
    want = capsys.readouterr().out
    rc, out, err = tw.torchrun(2, argv + ["--shard", "--collective", coll,
                                          "--checkpoint",
                                          str(tmp_path / "two")])
    assert rc == 0, out + err
    assert out.count("[train] sharding") == 1
    assert ("[train] sharding 4 workers over 2 devices (2 rows/shard, "
            f"collective={coll}, backend=gloo)") in out
    for key in ("averaging ops", "[train] loss"):
        assert (_line(out, key).split("), ")[-1]
                == _line(want, key).split("), ")[-1])
    if coll == "gather":
        assert _states_equal(str(tmp_path / "two"), str(tmp_path / "one"))


def test_cli_shard_checkpoint_then_resume_bitwise(tmp_path):
    """Under ``--shard`` (psum, 2 ranks) ``--checkpoint`` gathers the rows
    to rank 0, ``--resume`` gives every rank its rows back, and the
    resumed run ends where one run of all the steps ends, bit for
    bit."""
    import torch_sharded_worker as tw
    argv = SHARD_ARGV + ["--shard", "--comm-dtype", "int8"]
    ck = str(tmp_path / "run")
    outs = []
    for extra in (["--steps", "4", "--checkpoint", ck],
                  ["--steps", "4", "--resume", ck + ".state",
                   "--checkpoint", ck + "-resumed"],
                  ["--steps", "8", "--checkpoint", ck + "-whole"]):
        rc, out, err = tw.torchrun(2, argv + extra)
        assert rc == 0, out + err
        outs.append(out)
    assert f"resuming from {ck}.state at step 4" in outs[1]
    assert _states_equal(ck + "-resumed", ck + "-whole")
    assert not _states_equal(ck, ck + "-whole")


def test_cli_shard_in_a_world_of_one(capsys):
    """``--shard`` without torchrun: one rank holding every row; ``gather``
    is the unsharded run bit for bit."""
    argv = SHARD_ARGV + ["--steps", "4"]
    f0, h0, s0 = train.main(argv)
    capsys.readouterr()
    f1, h1, s1 = train.main(argv + ["--shard", "--collective", "gather"])
    assert ("[train] sharding 4 workers over 1 devices (4 rows/shard, "
            "collective=gather, backend=gloo)") in capsys.readouterr().out
    assert torch.equal(s1.plane, s0.plane)
    assert h1["dispersion"] == h0["dispersion"]


@pytest.mark.parametrize("argv", [["--collective", "ring"],
                                  ["--shard", "--collective", "allreduce"]],
                         ids=["collective", "shard-collective"])
def test_cli_refuses_bad_shard_flags_as_the_reference(argv, capsys):
    from repro.launch import train as jtrain
    with pytest.raises(SystemExit) as ej:
        jtrain.main(["--reduced", "--steps", "2"] + argv)
    assert ej.value.code == 2
    want = capsys.readouterr().err.splitlines()[-1]
    assert "invalid choice" in want
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--reduced", "--steps", "2"] + argv)
    assert e.value.code == 2
    assert capsys.readouterr().err.splitlines()[-1].split(": ", 1)[1] \
        == want.split(": ", 1)[1]


def test_cli_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        train.main(["--reduced", "--steps", "2"])
    assert e.value.code == 2


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import importlib.util, pkgutil, sys\n"
        "import repro_torch, repro_torch.launch.train\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch.distributed as dist\n"
        "import repro_torch.launch.dryrun\n"
        "print('INITIALIZED', dist.is_initialized())\n"
        "for name, path in [('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})] + [\n"
        "        (f, f'examples/{f}.py') for f in ('quickstart_torch', "
        "'serve_lm_torch', 'train_cnn_e2e_torch')]:\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib', 'repro.')) or n == 'repro')\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "INITIALIZED False" in out.stdout, out.stdout


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], env=ENV,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert not any(json.loads(ln).get("ok") for ln in
                   out.stdout.splitlines() if ln.startswith("{"))
