"""Step functions for training, prefill and decode: the counterparts of
``repro.launch.steps``'s ``make_optimizer``, ``make_train_step``,
``make_phase_step``, ``make_prefill_step`` and ``make_decode_step``.
(The reference's abstract input specs, which only its dry run lowers,
are not on this path.)

The training steps take worker trees (every leaf with the worker axis
first): ``make_train_step`` is one local step of every worker through
:func:`repro_torch.core.make_worker_step` (per-row gradients, the
optimizer's tree ``apply``), optionally with the average;
``make_phase_step`` runs ``phase_len`` such steps and the phase-end
average. With ``flat`` and a plane-protocol optimizer it runs them
flat-NATIVE, as the engine's default carry does: the params and the
optimizer state as (W, P) planes, the gradients from
:func:`repro_torch.core.make_plane_step`, each step one ``opt_step``
pass and the average one ``avg_disp`` pass — the CUDA kernels on the
card, their plain versions on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.averaging import average_all, average_inner
from repro_torch.core.engine import make_plane_step, make_worker_step
from repro_torch.core.flat import FlatOptSpec, FlatSpec, tree_map
from repro_torch.kernels.avg_disp import avg_disp
from repro_torch.kernels.opt_step import opt_step
from repro_torch.models import transformer as tfm
from repro_torch.optim import Momentum

AVGS = ("all", "inner", "none")


def make_optimizer():
    """Paper-faithful default: momentum SGD (paper §3.2 recipe)."""
    return Momentum(lr=0.01, mu=0.9)


def _lm_loss_fn(cfg: ModelConfig, *, impl: str, remat: bool):
    """Engine-signature loss: (params, batch, rng) -> (loss, aux)."""
    def loss_fn(params, batch, rng):
        return tfm.lm_loss(cfg, params, batch, impl=impl, remat=remat)
    return loss_fn


def make_train_step(cfg: ModelConfig, *, impl: str = "plain",
                    remat: bool = True, do_avg: bool = False,
                    inner_groups: int = 0, optimizer=None):
    """Local-SGD step over the worker axis (paper Eq. 3), built on the
    engine's shared worker step. With ``do_avg`` the model average
    follows; ``inner_groups`` > 0 averages hierarchically instead.

    Returns train_step(worker_params, opt_state, batch, step) ->
    (worker_params, opt_state, mean loss)."""
    opt = optimizer or make_optimizer()
    wstep = make_worker_step(_lm_loss_fn(cfg, impl=impl, remat=remat), opt)

    def train_step(worker_params, opt_state, batch, step):
        wp, os, loss, _ = wstep(worker_params, opt_state, batch, step)
        if do_avg:
            wp = (average_inner(wp, inner_groups) if inner_groups
                  else average_all(wp))
        return wp, os, torch.mean(loss)

    return train_step


def make_phase_step(cfg: ModelConfig, *, phase_len: int,
                    impl: str = "plain", remat: bool = True,
                    avg: str = "all", inner_groups: int = 0,
                    optimizer=None, flat: bool = False):
    """``phase_len`` local steps over a stacked (K, W, ...) batch block,
    then the phase-end average ("all" | "inner" | "none").

    ``flat`` runs the phase flat-native (module note) where the optimizer
    speaks the plane protocol; otherwise, as the reference does, the
    params plane is unpacked around the tree-mapped step and the average
    is the plain plane mean (no rounding codes: the unpack casts the
    mean to the leaf dtypes). Without ``flat`` the phase is the worker
    tree's, with the tree averages.

    Returns phase_step(worker_params, opt_state, batches, step0) ->
    (worker_params, opt_state, per-step mean losses (K,)); ``step0`` is
    the number of steps completed before the phase."""
    if avg not in AVGS:
        raise ValueError(f"avg must be one of {AVGS}, got {avg!r}")
    opt = optimizer or make_optimizer()
    loss_fn = _lm_loss_fn(cfg, impl=impl, remat=remat)
    wstep = make_worker_step(loss_fn, opt)
    groups = inner_groups if avg == "inner" and inner_groups else 1

    def phase_step(worker_params, opt_state, batches, step0):
        spec = FlatSpec.of(worker_params) if flat else None
        opt_spec = (FlatOptSpec.of(spec, opt_state)
                    if flat and getattr(opt, "plane_kind", None) else None)
        native = opt_spec is not None
        codes = None
        if native:
            grads_fn = make_plane_step(loss_fn, spec)
            plane = spec.pack(worker_params)
            codes = spec.rounding_codes(device=plane.device)
            carry_s = opt_spec.pack(opt_state)
        else:
            carry_p = spec.pack(worker_params) if flat else worker_params
            carry_s = opt_state
        losses = []
        for k in range(phase_len):
            batch = tree_map(lambda x: x[k], batches)
            step = step0 + k + 1
            if native:
                ls, _, gplane = grads_fn(plane, batch)
                plane, carry_s, _ = opt_step(
                    plane, gplane, carry_s, opt.plane_scalars(step),
                    kind=opt.plane_kind, mode="none", codes=codes,
                    **opt.plane_hypers())
            else:
                wp = spec.unpack(carry_p) if flat else carry_p
                wp, carry_s, ls, _ = wstep(wp, carry_s, batch, step)
                carry_p = spec.pack(wp) if flat else wp
            losses.append(torch.mean(ls))
        if native:
            if avg != "none":
                plane, _ = avg_disp(plane, groups=groups, codes=codes)
            wp, os = spec.unpack(plane), opt_spec.unpack(carry_s)
        elif flat:
            if avg != "none":
                carry_p, _ = avg_disp(carry_p, groups=groups)
            wp, os = spec.unpack(carry_p), carry_s
        else:
            wp, os = carry_p, carry_s
            if avg == "inner" and inner_groups:
                wp = average_inner(wp, inner_groups)
            elif avg != "none":  # "all", or "inner" with one group
                wp = average_all(wp)
        return wp, os, torch.stack(losses)

    return phase_step


def make_prefill_step(cfg: ModelConfig, *, impl: str = "kernel"):
    """(params, batch) -> the last position's fp32 logits (B, V), through
    the cacheless full-sequence forward of the whole batch (its "audio"
    or "media" frames included): with ``impl="kernel"`` every
    mixer's kernel runs, ``rwkv6_scan`` included (the cache-capturing
    prefill of ``serve.prefill`` takes the chunked WKV instead)."""
    def prefill_step(params, batch):
        return tfm.forward(cfg, params, batch, impl=impl)[:, -1]
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, tokens (B, 1), cache) -> (logits (B, 1, V), new cache)."""
    def decode_step(params, tokens, cache):
        return tfm.decode_step(cfg, params, tokens, cache)
    return decode_step
