"""Configs for the paper's own convex experiments (Zhang et al. 2016, §3.1):
least squares / logistic regression on synthetic stand-ins for the
paper's Table 1 datasets, in the same sparsity / rho regimes."""
from dataclasses import dataclass


@dataclass(frozen=True)
class ConvexConfig:
    """Synthetic stand-ins for the paper's Table 1 datasets."""
    name: str
    model: str               # "ls" | "lr"
    num_samples: int
    num_dims: int
    sparsity: float = 1.0    # fraction of nonzero features
    noise: float = 0.1
    num_workers: int = 24
    phase_lens: tuple = (1, 128, 1024, 0)   # 0 => one-shot


CONVEX_SUITE = (
    ConvexConfig("synth-ls-sparse-highrho", "ls", 4096, 1024, sparsity=0.01, noise=0.001),
    ConvexConfig("synth-ls-dense-lowrho", "ls", 8192, 64, sparsity=1.0, noise=3.0),
    ConvexConfig("synth-lr-sparse", "lr", 4096, 512, sparsity=0.02, noise=0.0),
    ConvexConfig("synth-lr-dense", "lr", 8192, 32, sparsity=1.0, noise=0.0),
)
