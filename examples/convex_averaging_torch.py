"""Paper §3.1 reproduction (Figure 2 + Table 1 workflow) on the synthetic
convex suite, on the PyTorch port: measures (σ², β², ρ) with the paper's
procedure, then runs the paper's grid-searched schedule comparison — the
averaging-frequency advantage correlates with ρ. The counterpart of
``examples/convex_averaging.py``, with its constants and printed lines.

Run:  PYTHONPATH=src python examples/convex_averaging_torch.py [--device cpu]
(on the card unless ``--device cpu``; without CUDA it refuses to start)
"""
import torch

from repro_torch import rng
from repro_torch.core.variance_model import empirical_variance_fn, measure_beta2, rho
from repro_torch.data import convex_dataset
from repro_torch.experiments.common import parse_device
from repro_torch.experiments.fig2_convex import grid_curves
from repro_torch.models.convex import solve_optimum


def main(argv=None):
    device = parse_device(argv, description=__doc__.split("\n\n")[0])
    for name, sparsity, noise in [("sparse-highrho", 0.02, 0.005),
                                  ("dense-lowrho", 1.0, 2.0)]:
        X, y, _ = convex_dataset("ls", 1024, 128, sparsity=sparsity,
                                 noise=noise, seed=0)
        X, y = torch.tensor(X, device=device), torch.tensor(y, device=device)
        w_star = solve_optimum("ls", X, y)
        vfn = empirical_variance_fn("ls", X, y)
        b2, s2 = measure_beta2(vfn, w_star, key=rng.PRNGKey(0),
                               num_lines=4)
        r = rho(b2, s2, torch.zeros(128, device=device), w_star)
        curves = grid_curves("ls", X, y, steps=2000,
                             phase_lens=(0, 128), lr_mults=(0.8, 3.0, 6.0),
                             device=str(device))
        one = curves["oneshot"][-1][1]
        per = curves["periodic_128"][-1][1]
        print(f"{name:16s} sigma2={s2:9.3e} beta2={b2:9.3e} rho={r:9.3e} | "
              f"normalized subopt: oneshot={one:9.3e} periodic128={per:9.3e} "
              f"ratio={one / max(per, 1e-15):7.2f}x")
    print("large rho -> large periodic-averaging advantage (paper's claim).")


if __name__ == "__main__":
    main()
