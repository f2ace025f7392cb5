"""Configs for the paper's own experiments (Zhang et al. 2016), the
reference package's dataclasses field for field:

- LeNet5-like CNN (§3.2): conv 32@5x5 -> relu -> maxpool/2 ->
  conv 64@5x5 -> relu -> maxpool/2 -> fc 512 -> fc 10, cross-entropy;
  Momentum SGD lr 0.01, momentum 0.9, x0.95 decay per epoch, 4 workers,
  minibatch 8, phase length 10.
- Convex problems (§3.1): least squares / logistic regression on
  synthetic stand-ins for the paper's Table 1 datasets, in the same
  sparsity / rho regimes.
- Scalar quadratic (§2.3 / Lemma 1), quartic and PCA (§2.4) settings.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-lenet5"
    image_size: int = 28
    in_channels: int = 1
    conv_channels: tuple = (32, 64)
    kernel_size: int = 5
    fc_hidden: int = 512
    num_classes: int = 10
    # the paper's training recipe
    lr: float = 0.01
    momentum: float = 0.9
    lr_decay_per_epoch: float = 0.95
    num_workers: int = 4
    batch_size: int = 8
    phase_len: int = 10


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


@dataclass(frozen=True)
class QuadraticConfig:
    """Scalar model of §2.3: f(w) = c w^2 / 2, grad noise b~N(0,beta2),
    h~N(0,sigma2); averaging with per-step probability zeta."""
    c: float = 1.0
    beta2: float = 4.0
    sigma2: float = 1.0
    alpha: float = 0.05
    num_workers: int = 24


@dataclass(frozen=True)
class QuarticConfig:
    """Non-convex example of §2.4: f(w) = (w^2-1)^2 with
    grad samples 4(w^3 - w + u), u ~ N(0,1)."""
    alpha: float = 0.025
    num_steps: int = 10_000
    num_workers: int = 24


@dataclass(frozen=True)
class PCAConfig:
    """Oja's rule PCA of §2.4: 20-dim Gaussian, spectrum [1.0, 0.7...]."""
    dim: int = 20
    top_eig: float = 1.0
    tail_eig: float = 0.7
    num_workers: int = 48
    num_samples: int = 10_000
    alpha: float = 0.01
