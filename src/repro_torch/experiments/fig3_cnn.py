"""Paper Figure 3: CNN (LeNet5-like) on MNIST-like data — one-shot vs
periodic (phase 10) vs best/worst single worker; momentum SGD lr .01,
mu .9, x0.95/epoch, 4 workers, batch 8 (the paper's exact recipe, with
a reduced step budget).

The port of ``benchmarks/bench_fig3_cnn.py``. Both schedules run through
the :class:`~repro_torch.core.PhaseEngine` (on the card: ``opt_step``
once a step, ``avg_disp`` once a periodic event), the per-worker metrics
read only at record boundaries. The image set is put on the device ONCE
(:class:`~repro_torch.data.DeviceDataset`); each phase hands the engine
a (K, M, B) index block from the per-worker permutation sharder and the
batches are gathered on the device. The reference runs its engine with
``scan_unroll=True`` (XLA:CPU under-threads rolled loops); the port's
phases are eager loops with nothing to unroll, so the setting is only
recorded (``SCAN_UNROLL``), as the training CLI's ``--scan-unroll``.

    python -m repro_torch.experiments.fig3_cnn [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.configs.paper import CNNConfig
from repro_torch.core import AveragingSchedule, PhaseEngine
from repro_torch.core.flat import tree_map
from repro_torch.data import DeviceDataset, mnist_like
from repro_torch.device import resolve_device
from repro_torch.experiments.common import cli, emit, save, timeit
from repro_torch.models.cnn import cnn_error, cnn_loss, init_cnn
from repro_torch.optim import Momentum, schedules

#: the reference's ``PhaseEngine(..., scan_unroll=True)``, recorded only
SCAN_UNROLL = True


def run_cnn(cfg: CNNConfig, steps: int, *, seed=0, record_every=25,
            eval_n=512, noise=0.6, device="cuda"):
    """{"periodic" | "oneshot": {"avg": [(t, train loss, test error)],
    "best" / "worst": [(t, the best / worst worker's train loss)]}}."""
    dev = resolve_device(device)
    # high sample noise so the task is not instantly memorizable and the
    # averaging-schedule differences are visible (paper Fig 3 regime)
    images, labels = mnist_like(4096, seed=seed, noise=noise)
    test_images, test_labels = mnist_like(eval_n, seed=seed + 1, noise=noise)
    M = cfg.num_workers
    params0 = init_cnn(cfg, rng.PRNGKey(seed), device=dev)
    # ONE dataset + sharder shared by both schedule runs (the second run
    # continues the permutation cursors, as the reference's does)
    dataset = DeviceDataset({"images": images, "labels": labels}, M,
                            batch_size=cfg.batch_size, seed=seed,
                            mode="permute", device=dev)
    steps_per_epoch = len(images) // (M * cfg.batch_size)
    # the paper's epoch decay counts steps from 0; engine steps are
    # 1-indexed, hence the -1
    epoch_lr = schedules.exponential_epoch(cfg.lr, cfg.lr_decay_per_epoch,
                                           steps_per_epoch)
    opt = Momentum(lr=lambda step: epoch_lr(step - 1), mu=cfg.momentum)

    def loss_fn(p, batch, rng_):
        return cnn_loss(cfg, p, batch), {}

    train = {"images": torch.tensor(images[:eval_n], device=dev),
             "labels": torch.tensor(labels[:eval_n], device=dev)}
    test = {"images": torch.tensor(test_images, device=dev),
            "labels": torch.tensor(test_labels, device=dev)}

    @torch.no_grad()
    def full_metrics(p):
        return cnn_loss(cfg, p, train), cnn_error(cfg, p, test)

    def eval_consensus(p):
        tr, te = full_metrics(p)
        return float(tr), float(te)

    def eval_workers(wp):
        trs = [float(full_metrics(tree_map(lambda x: x[i], wp))[0])
               for i in range(M)]
        return min(trs), max(trs)

    def run_schedule(phase_len):
        sch = (AveragingSchedule("periodic", phase_len) if phase_len
               else AveragingSchedule("oneshot"))
        # phase blocks = record period: averaging decisions are per step,
        # so one block can span several averaging phases
        engine = PhaseEngine(loss_fn, opt, sch, device=str(dev))
        _, hist = engine.run(params0, dataset, num_workers=M, seed=seed,
                             record_every=record_every,
                             eval_fn=eval_consensus,
                             worker_eval_fn=eval_workers,
                             phase_len=record_every, steps=steps)
        return {"avg": [(t, tr, te) for t, (tr, te) in hist["eval"]],
                "best": [(t, lo) for t, (lo, _) in hist["worker_eval"]],
                "worst": [(t, hi) for t, (_, hi) in hist["worker_eval"]]}

    return {"periodic": run_schedule(cfg.phase_len),
            "oneshot": run_schedule(0)}


def run(device="cuda"):
    cfg = CNNConfig()
    dt, out = timeit(lambda: run_cnn(cfg, steps=200, device=device), reps=1)
    save("bench_fig3_cnn", dict(out, scan_unroll=SCAN_UNROLL))
    p_final, p_err = out["periodic"]["avg"][-1][1:]
    o_final, o_err = out["oneshot"]["avg"][-1][1:]
    o_worst = out["oneshot"]["worst"][-1][1]
    p_best = out["periodic"]["best"][-1][1]
    emit("fig3_cnn_mnist", dt,
         f"periodic_loss={p_final:.3f}(err={p_err:.3f});"
         f"oneshot_loss={o_final:.3f}(err={o_err:.3f});"
         f"oneshot_worse_than_worst_worker={o_final > o_worst};"
         f"periodic_beats_best_worker={p_final <= p_best + 1e-6}")


if __name__ == "__main__":
    cli(run, description=__doc__.split("\n\n")[0])
