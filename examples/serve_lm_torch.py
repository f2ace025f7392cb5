"""Serving on the PyTorch port: batched greedy generation with KV / state
caches across three architecture families (dense GQA, RG-LRU hybrid,
RWKV SSM) through ``repro_torch.launch.serve`` — the counterpart of
``examples/serve_lm.py``, with its archs and sizes.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
(on the card unless ``--device cpu``; without CUDA it refuses to start)
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.launch.serve import main as serve_main

ARCHS = ["smollm-360m", "recurrentgemma-2b", "rwkv6-7b"]


def main(argv=None):
    """Serve each arch; returns {arch: generated tokens (2, 8)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(f"--device {args.device}: {e}")
    return {arch: serve_main(["--arch", arch, "--reduced", "--batch", "2",
                              "--prompt-len", "4", "--gen", "8",
                              "--device", args.device])
            for arch in ARCHS}


if __name__ == "__main__":
    main()
