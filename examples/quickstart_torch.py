"""Quickstart on the PyTorch port: periodic model averaging (the paper's
technique) on a small transformer LM — one-shot / periodic / minibatch
schedules on identical data, each run by ``repro_torch``'s PhaseEngine
(the flat-native planes: ``opt_step`` every step, ``avg_disp`` at each
periodic event, as CUDA kernels on the card). The counterpart of
``examples/quickstart.py``, with its constants and printed lines.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(on the card unless ``--device cpu``; without CUDA it refuses to start)
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import AveragingSchedule, PhaseEngine
from repro_torch.data import token_stream
from repro_torch.device import resolve_device
from repro_torch.models import init_params, lm_loss
from repro_torch.optim import Momentum

WORKERS, STEPS, BATCH, SEQ = 4, 60, 4, 64


def batch_iter(cfg, seed):
    streams = [token_stream(cfg.vocab_size, BATCH, SEQ, seed=seed * 31 + i)
               for i in range(WORKERS)]
    for _ in range(STEPS):
        yield {"tokens": np.stack([next(s) for s in streams])}


def main(argv=None):
    """Train the three schedules, print the reference's lines. Returns
    {schedule: {"averages", "loss" (the recorded history), "eval_loss"}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"--device {args.device}: {e}")
    cfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                              dtype="float32")
    params = init_params(cfg, 0, device=device)

    def loss_fn(p, batch, rng):
        return lm_loss(cfg, p, batch)

    print(f"model: {cfg.name} ({cfg.num_params()/1e6:.1f}M params), "
          f"{WORKERS} workers, {STEPS} steps")
    results = {}
    for name, sch in {
        "oneshot": AveragingSchedule("oneshot"),
        "periodic_10": AveragingSchedule("periodic", 10),
        "minibatch": AveragingSchedule("minibatch"),
    }.items():
        engine = PhaseEngine(loss_fn, Momentum(lr=0.05, mu=0.9), sch,
                             device=str(device))
        final, hist = engine.run(params, batch_iter(cfg, 7),
                                 num_workers=WORKERS, seed=0,
                                 record_every=10)
        # evaluate the consensus model on a held-out batch
        ev = next(batch_iter(cfg, 99))
        with torch.no_grad():
            loss, _ = lm_loss(cfg, final, {"tokens": torch.from_numpy(
                ev["tokens"][0]).to(device)})
        results[name] = {"averages": hist["averages"], "loss": hist["loss"],
                         "eval_loss": float(loss)}
        print(f"  {name:12s}: {hist['averages']:3d} averages, "
              f"final consensus eval loss {float(loss):.4f}")
    assert results["periodic_10"]["eval_loss"] \
        <= results["oneshot"]["eval_loss"] + 0.5
    print("done — periodic averaging tracks/beats one-shot, as the paper "
          "predicts for non-convex objectives.")
    return results


if __name__ == "__main__":
    main()
