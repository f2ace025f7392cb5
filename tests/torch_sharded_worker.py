"""Ranks of ``tests/test_torch_sharded.py``: the sharded port engine on
gloo processes over the CPU.

Every configuration of the reference's sharded suite
(``tests/test_sharded.py``'s ``_SCRIPT``: DIM 12, 256 samples, M=16
workers, 41 steps, Momentum lr 0.05 / mu 0.9, seed 3) plus fault plans,
telemetry and an elastic run, each under both collectives, on a worker
mesh over every rank of the world; each rank appends a line to
``<out>/rank<r>.progress`` as it finishes a run and pickles its results
to ``<out>/rank<r>.pkl`` (a traceback on failure).

    python tests/torch_sharded_worker.py WORLD RENDEZVOUS_FILE OUT

imports torch and the port once and forks the WORLD ranks from there
(:func:`serve`), so that no rank spends its share of a loaded host on
the imports again.

This module imports only ``numpy``, ``torch`` and ``repro_torch`` (never
``jax``): the test process imports it for the configuration table,
:func:`start` and :func:`collect`, and the ranks run it as a script.
"""
from __future__ import annotations

import datetime
import os
import pickle
import signal
import subprocess
import sys
import time
import traceback

import numpy as np

DIM, SAMPLES, WORKERS, STEPS, SEED = 12, 256, 16, 41, 3
LR, MU = 0.05, 0.9
COLLECTIVES = ("gather", "psum")

SCHEDULES = {
    "oneshot": dict(kind="oneshot"),
    "minibatch": dict(kind="minibatch"),
    "periodic": dict(kind="periodic", phase_len=8),
    "stochastic": dict(kind="stochastic", zeta=0.2),
    "hierarchical": dict(kind="hierarchical", inner_phase_len=5,
                         outer_phase_len=20, inner_groups=2),
    "adaptive_threshold": dict(kind="adaptive_threshold",
                               disp_threshold=0.5, disp_ema_beta=0.5),
    "adaptive_budget": dict(kind="adaptive_budget", comm_budget=6,
                            budget_horizon=STEPS),
}
#: the fault plan of the ``faults-*`` configurations: a crash and a
#: rejoin (one curriculum step) and a crash without one, on rows of
#: different ranks, and stragglers
FAULT_TEXT = "crash:m=5@t=10,rejoin:m=5@t=20,crash:m=12@t=15"
STRAGGLE, CURRICULUM = 0.25, 1
#: the elastic run: shrink to 12 rows before step 14 (a mesh of 6 of the 8
#: ranks: two sit the segment out), grow back to 16 before step 28
ELASTIC = dict(resizes=((14, 12), (28, 16)), curriculum=2)

CONFIGS = {name: dict(sched=name) for name in SCHEDULES}
CONFIGS["outer"] = dict(sched="periodic", outer=(0.8, 0.5))
#: inner events over one group are plain means; only the outer ones step
#: the outer optimizer
CONFIGS["outer-hierarchical"] = dict(sched="hierarchical", inner_groups=1,
                                     outer=(0.8, 0.5))
CONFIGS["indexed"] = dict(sched="periodic", indexed=True)
for _kind in ("ring", "torus", "gossip_pairs"):
    CONFIGS[f"topology-{_kind}"] = dict(sched="periodic", topology=_kind)
for _wire in ("bf16", "int8", "one_bit"):
    for _s in ("periodic", "stochastic", "adaptive_budget"):
        CONFIGS[f"{_wire}-{_s}"] = dict(sched=_s, wire=_wire)
CONFIGS["int8-ring"] = dict(sched="periodic", topology="ring", wire="int8")
for _s in ("periodic", "hierarchical", "minibatch"):
    CONFIGS[f"faults-{_s}"] = dict(sched=_s, faults=True)
CONFIGS["faults-ring-int8"] = dict(sched="periodic", topology="ring",
                                   wire="int8", faults=True)
CONFIGS["telemetry"] = dict(sched="periodic", faults=True, telemetry=True)
CONFIGS["elastic"] = dict(sched="periodic", elastic=True)


def problem():
    """The reference script's draws: X (256, 12), y, the (41, 16, 8)
    sample indices; X and y in float32, as the reference's arrays are."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((SAMPLES, DIM))
    y = X @ rng.standard_normal(DIM)
    idx = rng.integers(0, SAMPLES, (STEPS, WORKERS, 8))
    return X.astype(np.float32), y.astype(np.float32), idx


def engine_kwargs(name: str, ns) -> dict:
    """The engine keywords of configuration ``name`` from ``ns``, a
    namespace holding ``AveragingSchedule``, ``OuterOptimizer``,
    ``Topology``, ``Compression`` and ``FaultPlan`` of either package."""
    cfg = CONFIGS[name]
    sched = dict(SCHEDULES[cfg["sched"]])
    if "inner_groups" in cfg:
        sched["inner_groups"] = cfg["inner_groups"]
    kw = dict(schedule=ns.AveragingSchedule(**sched))
    if "outer" in cfg:
        lr, mom = cfg["outer"]
        kw["outer"] = ns.OuterOptimizer(lr=lr, momentum=mom)
    if "topology" in cfg:
        kw["topology"] = ns.Topology.build(cfg["topology"], WORKERS)
    if "wire" in cfg:
        kw["compression"] = ns.Compression(cfg["wire"])
    if cfg.get("faults"):
        kw["faults"] = ns.FaultPlan.parse(FAULT_TEXT, WORKERS,
                                          straggle_prob=STRAGGLE,
                                          rejoin_curriculum=CURRICULUM)
    if cfg.get("telemetry"):
        kw["telemetry"] = True
    return kw


def port_ns():
    from types import SimpleNamespace

    from repro_torch.core import AveragingSchedule
    from repro_torch.core.averaging import OuterOptimizer
    from repro_torch.core.compress import Compression
    from repro_torch.faults import FaultPlan
    from repro_torch.topology import Topology
    return SimpleNamespace(AveragingSchedule=AveragingSchedule,
                           OuterOptimizer=OuterOptimizer, Topology=Topology,
                           Compression=Compression, FaultPlan=FaultPlan)


def port_loss(p, b, r):
    res = b["x"] @ p["w"] - b["y"]
    return 0.5 * (res * res).mean(), {}


def strip(hist: dict) -> dict:
    """A history without ``phase_wall`` (each rank's own clock)."""
    return {k: v for k, v in hist.items() if k != "phase_wall"}


def port_run(name: str, **engine_extra):
    """Configuration ``name`` on the port's engine over the CPU
    (``engine_extra``: ``mesh=`` and ``collective=`` for a sharded run).
    Returns ({w, hist[, records]}, final state, engine)."""
    import torch

    from repro_torch.core import PhaseEngine
    from repro_torch.data.pipeline import DeviceDataset
    from repro_torch.elastic import ElasticPlan, run_elastic
    from repro_torch.optim import Momentum
    from repro_torch.telemetry import MemorySink

    X, y, idx = problem()
    cfg = CONFIGS[name]
    eng = PhaseEngine(port_loss, Momentum(lr=LR, mu=MU), device="cpu",
                      **engine_kwargs(name, port_ns()), **engine_extra)
    params = {"w": torch.zeros(DIM)}
    kw = dict(seed=SEED, record_every=1, return_state=True)
    if cfg.get("telemetry"):
        kw["sink"] = MemorySink()
    if cfg.get("elastic"):
        plan = ElasticPlan(WORKERS, ELASTIC["resizes"],
                           ELASTIC["curriculum"])

        def data(m, t0, k):
            return [{"x": X[idx[t, :m]], "y": y[idx[t, :m]]}
                    for t in range(t0 - 1, t0 - 1 + k)]
        final, hist, state = run_elastic(eng, params, data, plan,
                                         steps=STEPS, **kw)
    else:
        if cfg.get("indexed"):
            data = DeviceDataset({"x": torch.from_numpy(X),
                                  "y": torch.from_numpy(y)}, WORKERS,
                                 indices=idx, device="cpu")
        else:
            data = [{"x": X[idx[t]], "y": y[idx[t]]} for t in range(STEPS)]
        final, hist, state = eng.run(params, data, num_workers=WORKERS,
                                     **kw)
    out = dict(w=final["w"].numpy().copy(), hist=strip(hist))
    if "sink" in kw:
        out["records"] = [{k: v for k, v in r.items()
                           if k not in ("wall_s", "steps_per_s", "t")}
                          for r in kw["sink"].records]
    return out, state, eng


def phase_metrics(eng, steps: int = 8):
    """The telemetry accumulator of one phase of ``steps`` steps."""
    import torch
    X, y, idx = problem()
    state = eng.init({"w": torch.zeros(DIM)}, WORKERS, SEED)
    _, trace = eng.run_phase(state, [{"x": X[idx[t]], "y": y[idx[t]]}
                                     for t in range(steps)])
    return np.asarray(trace["metrics"]).copy()


def main(rank: int, world: int, rendezvous: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    path = os.path.join(out, f"rank{rank}.pkl")
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{rendezvous}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        from repro_torch.launch.mesh import make_worker_mesh
        mesh = make_worker_mesh(WORKERS, backend="gloo", device="cpu")
        results, t0 = {}, time.perf_counter()
        for name in CONFIGS:
            for coll in COLLECTIVES:
                res, state, eng = port_run(name, mesh=mesh, collective=coll)
                if state.plane.shape[0]:
                    res["rows"] = state.plane.numpy().copy()
                    res["row_range"] = mesh.row_range(WORKERS)
                if CONFIGS[name].get("telemetry"):
                    res["metrics"] = phase_metrics(eng)
                results[(name, coll)] = res
                with open(os.path.join(out, f"rank{rank}.progress"),
                          "a") as f:
                    f.write(f"{name} {coll}\n")
        results["seconds"] = time.perf_counter() - t0
        results["modules"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "repro"))
        dist.destroy_process_group()
    except BaseException:  # reported to the test through the file
        results = {"error": traceback.format_exc()}
    with open(path + ".tmp", "wb") as f:
        pickle.dump(results, f)
    os.replace(path + ".tmp", path)
    if "error" in results:
        sys.exit(1)


def serve(world: int, rendezvous: str, out: str) -> None:
    """Fork the ``world`` ranks of :func:`main` from this process once it
    has imported what they run (it has one thread then: torch starts
    none at import, so the forks are safe); rank r writes its output to
    ``<out>/rank<r>.log``. Exits 1 when a rank failed."""
    import torch  # noqa: F401  (imported once, before the forks)

    import repro_torch.core  # noqa: F401
    import repro_torch.elastic  # noqa: F401
    import repro_torch.launch.mesh  # noqa: F401
    import repro_torch.telemetry  # noqa: F401
    port_ns()
    for r in range(world):
        if os.fork() == 0:
            code = 1
            try:
                fd = os.open(os.path.join(out, f"rank{r}.log"),
                             os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
                os.dup2(fd, 1)
                os.dup2(fd, 2)
                main(r, world, rendezvous, out)
                code = 0
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else 1
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(code)
    failed = False
    for _ in range(world):
        _, status = os.wait()
        failed |= status != 0
    sys.exit(1 if failed else 0)


def start(world: int, workdir: str):
    """Start :func:`serve`'s ``world`` ranks, which rendezvous over a file
    in ``workdir``, in a session of their own; returns its process,
    running (see :func:`collect`). The ranks wait on every rank at each
    collective, so a rank kept off the CPU stalls them all; under
    autogroup scheduling their own session gets a CPU share of its own
    beside the busy test workers (on an 8-core host under 20 busy
    threads: 63 s, against 174 s in the test's session)."""
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env["PYTHONPATH"] = os.pathsep.join([src, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(world),
         os.path.join(workdir, "rendezvous"), workdir], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)


def _read(path: str) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()
    except FileNotFoundError:
        return ""


#: seconds without a finished run, and in all, before :func:`collect`
#: kills the ranks: the 54 runs take 31-39 s in all on an idle 8-core
#: host, 63 s beside busy test workers, a run a few seconds at most
STALL_S, TIMEOUT_S = 120.0, 400.0
AUTOGROUP = "/proc/sys/kernel/sched_autogroup_enabled"


def _autogroup() -> str:
    """The host's autogroup setting, which gives the ranks' session its
    own CPU share (:func:`start`): "1", "0" or "absent"."""
    try:
        with open(AUTOGROUP) as f:
            return f.read().strip()
    except OSError:
        return "absent"


def collect(proc, workdir: str, world: int) -> list:
    """Each rank's results of :func:`start`'s process. The ranks report
    each run they finish (``rank<r>.progress``); they are killed, and
    this raises with their logs, once no rank has reported one for
    ``STALL_S`` seconds (a hang) or ``TIMEOUT_S`` after the call. A
    rank's failure raises with its traceback."""
    progress = [os.path.join(workdir, f"rank{r}.progress")
                for r in range(world)]
    t0 = last = time.monotonic()
    seen, stuck = -1, None
    try:
        while proc.poll() is None:
            now = time.monotonic()
            done = sum(os.path.getsize(p) for p in progress
                       if os.path.exists(p))
            if done != seen:
                seen, last = done, now
            if now - last > STALL_S or now - t0 > TIMEOUT_S:
                runs = sum(_read(p).count("\n") for p in progress)
                stuck = (f"no rank finished a run in {now - last:.0f} s, "
                         f"{now - t0:.0f} s after the start, {runs} runs "
                         f"finished over the ranks (autogroup: "
                         f"{_autogroup()})")
                break
            time.sleep(0.2)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    logs = [_read(os.path.join(workdir, f"rank{r}.log"))
            for r in range(world)]
    if stuck is not None:
        raise RuntimeError(f"the ranks were killed: {stuck}\n"
                           + "\n".join(f"--- rank {r}:\n{log}"
                                       for r, log in enumerate(logs)))
    results = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} wrote no result:\n" + logs[r])
        with open(path, "rb") as f:
            res = pickle.load(f)
        if "error" in res:
            raise RuntimeError(f"rank {r} failed:\n{res['error']}")
        results.append(res)
    return results


def torchrun(nproc: int, argv: list, *, timeout: float = 300.0,
             module: str = "repro_torch.launch.train"):
    """``torchrun --standalone --nproc-per-node nproc -m module argv``
    on one thread a rank; the whole process group is killed at
    ``timeout`` seconds. Returns (exit code, stdout, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env["PYTHONPATH"] = os.pathsep.join([src, env.get("PYTHONPATH", "")])
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", "-m", module, *argv], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return p.returncode, out, err


if __name__ == "__main__":
    serve(int(sys.argv[1]), sys.argv[2], sys.argv[3])
