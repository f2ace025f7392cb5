"""LeNet5-like CNN, the model of the paper's §3.2 non-convex experiment.

conv 32@5x5 -> relu -> maxpool/2 -> conv 64@5x5 -> relu -> maxpool/2
-> fc(hidden) -> relu -> fc(classes) -> softmax cross-entropy.

The reference's parameter tree exactly (``conv1/conv2/fc1/fc2``, each
``w``/``b``; HWIO conv weights) and its NHWC images, so that
``convert.params_from_jax`` carries its params across, ``FlatSpec`` lays
the plane out element for element as the reference's does, and its
checkpoints load; the forward pass permutes to PyTorch's NCHW / OIHW
inside. The pooling is ``F.max_pool2d``. Each convolution (SAME
padding) is an im2col product, ``F.unfold`` then one float32 matmul,
not ``F.conv2d``: on an H100 (cuDNN 9.2, TF32 off) cuDNN's convolution
gradients at this model's shapes part from float64 by some 1e-3 of
their scale, where the unfolded product, like PyTorch's own CUDA
convolution, parts by under 1e-6 (``chip_smoke.py``'s
``conv_gradients`` measures all three). This is work the reference
computes outside any kernel of its own.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rng
from repro_torch.configs.paper import CNNConfig


def init_cnn(cfg: CNNConfig, key, *, device="cuda"):
    """The reference's init: ``split(key, 4)``, each weight a normal draw
    scaled by sqrt(2 / fan_in) (within a few float32 ulps of
    ``jax.random.normal``), zero biases; float32 on ``device``."""
    ks = rng.split(key, 4)
    c1, c2 = cfg.conv_channels
    k = cfg.kernel_size
    # 'SAME' convs + two stride-2 pools
    feat = (cfg.image_size // 4) ** 2 * c2

    def glorot(key, shape, fan_in):
        scale = float(np.float32(np.sqrt(2.0 / fan_in)))
        return rng.normal(key, shape, device=device) * scale

    def zeros(n):
        return torch.zeros(n, device=device)

    return {
        "conv1": {"w": glorot(ks[0], (k, k, cfg.in_channels, c1),
                              k * k * cfg.in_channels), "b": zeros(c1)},
        "conv2": {"w": glorot(ks[1], (k, k, c1, c2), k * k * c1),
                  "b": zeros(c2)},
        "fc1": {"w": glorot(ks[2], (feat, cfg.fc_hidden), feat),
                "b": zeros(cfg.fc_hidden)},
        "fc2": {"w": glorot(ks[3], (cfg.fc_hidden, cfg.num_classes),
                            cfg.fc_hidden), "b": zeros(cfg.num_classes)},
    }


def _conv(x, p):
    """SAME convolution of NCHW ``x`` by the HWIO weight ``p["w"]``: the
    input padded as XLA pads SAME ((k - 1) // 2 before, k // 2 after),
    unfolded into (B, C k k, H W) columns, times the weight as an
    (O, C k k) matrix in the same (C, kh, kw) order, plus the bias."""
    k, _, _, o = p["w"].shape
    b, _, h, w = x.shape
    lo, hi = (k - 1) // 2, k // 2
    cols = F.unfold(F.pad(x, (lo, hi, lo, hi)), k)
    wmat = p["w"].permute(3, 2, 0, 1).reshape(o, -1)
    return (wmat @ cols).reshape(b, o, h, w) + p["b"][:, None, None]


def cnn_forward(cfg: CNNConfig, params, images):
    """images: (B, H, W, C) float32 -> logits (B, classes)."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv1"])), 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv2"])), 2)
    # flatten in the reference's (H, W, C) order
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def cnn_loss(cfg: CNNConfig, params, batch):
    logits = cnn_forward(cfg, params, batch["images"])
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[:, None])
    return torch.mean(nll)


def cnn_error(cfg: CNNConfig, params, batch):
    logits = cnn_forward(cfg, params, batch["images"])
    return torch.mean((torch.argmax(logits, -1)
                       != batch["labels"].long()).float())
