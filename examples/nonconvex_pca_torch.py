"""Paper §2.4 / Figure 1 on the PyTorch port: one-shot averaging fails for
non-convex problems (PCA via Oja's rule and the quartic example);
periodic averaging fixes it. The counterpart of
``examples/nonconvex_pca.py``, with its constants and printed lines.

Run:  PYTHONPATH=src python examples/nonconvex_pca_torch.py [--device cpu]
(on the card unless ``--device cpu``; without CUDA it refuses to start)
"""
from repro_torch.configs.paper import PCAConfig, QuarticConfig
from repro_torch.experiments.common import parse_device
from repro_torch.experiments.fig1_pca import pca_error_vs_avg_steps
from repro_torch.experiments.quartic import run_quartic


def main(argv=None):
    device = str(parse_device(argv, description=__doc__.split("\n\n")[0]))
    print("== quartic f(w)=(w^2-1)^2  (paper: oneshot .922 / 0.1% .274 / "
          "10% .011)")
    for r in run_quartic(QuarticConfig(), [0.0, 0.001, 0.01, 0.1],
                         device=device):
        label = "one-shot" if r["avg_frac"] == 0 else f"{r['avg_frac']:.1%}"
        print(f"  averaging {label:>8s}: objective {r['objective']:.3f}")

    print("== PCA via Oja's rule (paper Fig 1)")
    cfg = PCAConfig(num_workers=24, num_samples=3000, alpha=0.02)
    for r in pca_error_vs_avg_steps(cfg, [0, 1000, 250, 50, 10],
                                    device=device):
        print(f"  {r['num_avg_steps']:5d} averaging steps: "
              f"PC error {r['pc_error']:.4f}")
    print("more averaging -> lower PC error; one-shot is the worst point, "
          "matching the paper.")


if __name__ == "__main__":
    main()
