"""End-to-end driver on the PyTorch port (paper §3.2 kind): train the
LeNet5-like CNN with 4 workers x periodic averaging, the paper's recipe
(momentum SGD lr .01 mu .9, x0.95/epoch decay, batch 8, phase length 10,
per-worker data permutations), with a checkpoint round trip through
``repro_torch.checkpoint`` and train/test evaluation of the consensus
model — the counterpart of ``examples/train_cnn_e2e.py``.

Run:  PYTHONPATH=src python examples/train_cnn_e2e_torch.py [--steps 300]
      [--device cpu] [--ckpt PATH]
(on the card unless ``--device cpu``; without CUDA it refuses to start)
"""
import argparse
import os
import tempfile

import torch

from repro_torch import rng
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.paper import CNNConfig
from repro_torch.core import AveragingSchedule, PhaseEngine
from repro_torch.core.flat import tree_map
from repro_torch.data import WorkerSharder, mnist_like
from repro_torch.device import resolve_device
from repro_torch.models.cnn import cnn_error, cnn_loss, init_cnn
from repro_torch.optim import Momentum, schedules


def main(argv=None):
    """Train, print the reference's lines, save and restore the consensus
    model. Returns {"final", "hist", "restored", "step"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_cnn_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"--device {args.device}: {e}")

    cfg = CNNConfig()
    images, labels = mnist_like(8192, seed=0)
    test_images, test_labels = mnist_like(1024, seed=1)
    M = cfg.num_workers
    sharder = WorkerSharder(len(images), M, seed=0, mode="permute")
    steps_per_epoch = len(images) // (M * cfg.batch_size)

    params = init_cnn(cfg, rng.PRNGKey(0), device=device)
    opt = Momentum(lr=schedules.exponential_epoch(
        cfg.lr, cfg.lr_decay_per_epoch, steps_per_epoch), mu=cfg.momentum)

    def loss_fn(p, batch, key):
        return cnn_loss(cfg, p, batch), {}

    engine = PhaseEngine(loss_fn, opt,
                         AveragingSchedule("periodic", cfg.phase_len),
                         device=str(device))

    def batches():
        for _ in range(args.steps):
            idx = sharder.next_indices(cfg.batch_size)
            yield {"images": images[idx], "labels": labels[idx]}

    test = {"images": torch.from_numpy(test_images).to(device),
            "labels": torch.from_numpy(test_labels).to(device)}

    def test_err(p):
        with torch.no_grad():
            return float(cnn_error(cfg, p, test))

    final, hist = engine.run(params, batches(), num_workers=M, seed=0,
                             record_every=25, eval_fn=test_err)
    print(f"trained {args.steps} steps, {hist['averages']} averages")
    for (s, l), (_, e) in zip(hist["loss"], hist["eval"]):
        print(f"  step {s:4d}: train loss {l:.4f}  test err {e:.3f}")
    save_checkpoint(args.ckpt, final, step=args.steps)
    restored, step = load_checkpoint(args.ckpt,
                                     tree_map(torch.zeros_like, final))
    assert step == args.steps
    print(f"checkpoint round-trip OK -> {args.ckpt}.npz "
          f"(final test err {test_err(restored):.3f})")
    return {"final": final, "hist": hist, "restored": restored,
            "step": step}


if __name__ == "__main__":
    main()
