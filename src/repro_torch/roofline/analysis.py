"""Roofline terms of a step, counted on ``meta`` tensors.

  compute term    = flops_per_device / peak_flops
  memory term     = bytes_per_device / hbm_bw
  collective term = collective_bytes_per_device / net_bw

The counterpart of ``repro.roofline.analysis``. Where the reference reads
``compiled.cost_analysis()`` and the collectives of the SPMD HLO text,
the port has no compiler to ask: :func:`count_step` runs the step itself
on ``meta`` tensors (shapes and dtypes, no data, no device) under one
``TorchDispatchMode`` and counts every aten op it dispatches, and
:func:`collective_bytes` reads what a
:class:`~repro_torch.launch.mesh.WorkerMesh` counted
(``read_stats()``). Flops and bytes are counted for the whole step;
per device they are that count over ``chips``, the reference's own
accounting (global / (chips x peak) = per device / peak). Collective
bytes are payload bytes a device sends a call (the result-shape bytes of
an all-gather), without ring-algorithm multipliers, as the reference
reports them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.compress import WIRE_BITS


@dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM5, from NVIDIA's published data sheet (dense
    rates, no sparsity, at its 700 W limit): spec constants, not
    measurements.

    ``peak_flops``: 989.4e12 bf16 FLOP/s on the tensor cores, the rate
    every counted flop is priced at (as the reference prices its flops
    at its chip's bf16 peak). ``hbm_bw``: 3.35e12 B/s of HBM3.
    ``net_bw``: 50e9 B/s, one 400 Gb/s NDR InfiniBand port (ConnectX-7)
    a card. The production mesh's worker axes span 16 or 32 nodes of
    eight cards, so the phase-end average crosses the network, not the
    900 GB/s NVLink inside a node."""
    peak_flops: float = 989.4e12
    hbm_bw: float = 3.35e12
    net_bw: float = 50e9


def wire_scale(wire: str = "f32") -> float:
    """Asymptotic bytes-on-the-wire fraction of an f32 payload shipped
    in ``wire`` format (``repro_torch.core.compress.WIRE_BITS``; the
    per-row f32 scale of the scaled formats vanishes at roofline widths):
    1.0 / 0.5 / 0.25 / 0.03125 for f32 / bf16 / int8 / one_bit."""
    if wire not in WIRE_BITS:
        raise ValueError(f"unknown wire format {wire!r}; "
                         f"pick one of {tuple(WIRE_BITS)}")
    return WIRE_BITS[wire] / 32.0


def analytic_params(cfg) -> int:
    """The reference's analytic parameter count
    (``repro.configs.ModelConfig.num_params``), which 6·N·D prices: the
    port's ``ModelConfig.num_params`` counts every leaf of the port's
    tree instead, and differs from it for the RG-LRU, RWKV, layernorm,
    cross-attention and encoder archs (its docstring says where), so the
    dry run's ``model_flops`` keep the reference's count."""
    d = cfg.d_model
    attn = d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
    mult = 3 if cfg.gated_mlp else 2
    n = cfg.padded_vocab * d  # embed
    if not cfg.tie_embeddings:
        n += cfg.padded_vocab * d
    for spec in cfg.layers:
        if spec.mixer in ("attn", "attn_local"):
            n += attn
        elif spec.mixer == "rglru":
            w = cfg.rnn_width or d
            n += 2 * d * w + w * d + cfg.conv_width * w + 3 * w
        elif spec.mixer == "rwkv":
            n += 4 * d * d + d * d // 2  # r,k,v,o + decay lora approx
        if spec.cross_attn:
            n += attn
        if spec.ffn == "dense":
            n += mult * d * cfg.d_ff
        elif spec.ffn == "moe":
            n += cfg.num_experts * mult * d * cfg.moe_d_ff
            n += d * cfg.num_experts  # router
            if cfg.shared_expert:
                n += mult * d * cfg.moe_d_ff
        elif spec.ffn == "rwkv_cmix":
            n += 2 * d * cfg.d_ff
        n += 2 * d  # norms
    n += cfg.encoder_layers * (attn + mult * d * cfg.d_ff + 2 * d)
    return n


def analytic_active_params(cfg) -> int:
    """:func:`analytic_params` less, in every MoE layer, the
    ``num_experts - top_k`` experts a token is not routed to."""
    if cfg.num_experts == 0:
        return analytic_params(cfg)
    mult = 3 if cfg.gated_mlp else 2
    moe_layers = sum(1 for s in cfg.layers if s.ffn == "moe")
    dead = (cfg.num_experts - cfg.top_k) * mult * cfg.d_model * cfg.moe_d_ff
    return analytic_params(cfg) - moe_layers * dead


def model_flops(cfg, shape, *, training: bool) -> float:
    """6·N_active·D for train, 2·N_active·D for inference (global);
    N_active the reference's analytic count
    (:func:`analytic_active_params`)."""
    n = analytic_active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


# --------------------------------------------------------------------------
# The counter
# --------------------------------------------------------------------------

#: ops that move no bytes in eager PyTorch besides the views (``is_view``):
#: allocations without a fill, and views that declare no alias
_FREE_OPS = frozenset({
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::_unsafe_view",
    "aten::lift_fresh", "aten::lift_fresh_copy"})


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's distinct elements take: a broadcast
    (stride-0) dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _walk(x, seen: dict) -> None:
    """The distinct tensors of a nested structure into ``seen`` (by
    identity)."""
    if isinstance(x, torch.Tensor):
        seen[id(x)] = x
    elif isinstance(x, (list, tuple)):
        for v in x:
            _walk(v, seen)
    elif isinstance(x, dict):
        for v in x.values():
            _walk(v, seen)


def _tree_bytes(*trees) -> int:
    seen = {}
    for t in trees:
        _walk(t, seen)
    return sum(tensor_bytes(t) for t in seen.values())


@dataclass(frozen=True)
class StepCounts:
    """What :func:`count_step` counted: ``flops`` (matmuls, convolutions
    and attention, from ``torch.utils.flop_counter``'s registry),
    ``bytes`` (every aten op's operand and result bytes), ``ops`` (aten
    ops dispatched), the argument and output bytes of the step, and the
    host seconds the count took."""
    flops: float = 0.0
    bytes: float = 0.0
    ops: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    seconds: float = 0.0

    def scaled(self, k: float) -> "StepCounts":
        """The work of ``k`` such steps (arguments and outputs as they
        are)."""
        return replace(self, flops=self.flops * k, bytes=self.bytes * k,
                       ops=int(self.ops * k))

    def __add__(self, other: "StepCounts") -> "StepCounts":
        """Two pieces of one step: their work added (the first's
        arguments and outputs kept)."""
        return replace(self, flops=self.flops + other.flops,
                       bytes=self.bytes + other.bytes,
                       ops=self.ops + other.ops,
                       seconds=self.seconds + other.seconds)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self._moves: dict = {}  # op -> whether it moves bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        moves = self._moves.get(func)
        if moves is None:
            moves = self._moves[func] = not (func.is_view or
                                             func.name() in _FREE_OPS)
        if moves:
            self.bytes += _tree_bytes(args, kwargs) + _tree_bytes(out)
        return out


def count_step(fn, *args, **kwargs) -> StepCounts:
    """Run ``fn(*args, **kwargs)`` — on ``meta`` tensors, so nothing is
    computed or allocated — under one dispatch mode, and count it: the
    flops of every op in ``torch.utils.flop_counter``'s registry (2MNK a
    matmul; elementwise ops count none, where XLA's cost analysis counts
    them too), and the bytes of every op's operands and result, views
    and bare allocations excepted. That is what eager PyTorch moves op by
    op when each op reads its inputs from memory and writes its output
    back (an operand still in the L2 cache costs less); it is not XLA's
    ``bytes accessed``, which is counted after fusion."""
    t0 = time.perf_counter()
    counter = _Counter()
    with counter:
        out = fn(*args, **kwargs)
    return StepCounts(flops=float(counter.flops), bytes=float(counter.bytes),
                      ops=counter.ops,
                      argument_bytes=_tree_bytes(args, kwargs),
                      output_bytes=_tree_bytes(out),
                      seconds=time.perf_counter() - t0)


# --------------------------------------------------------------------------
# Collectives and the report
# --------------------------------------------------------------------------

def collective_bytes(stats: dict | None, *, wire: str = "f32") -> dict:
    """Bytes a device sends per collective, from
    ``WorkerMesh.read_stats()``: each collective's float32 bytes scaled
    by :func:`wire_scale` (a compressed deployment ships those planes
    encoded), bytes of other dtypes (already reduced precisions, packed
    or integer payloads) as they are. Returns {name: bytes, ...,
    "total": bytes, "counts": {name: calls}}."""
    scale = wire_scale(wire)
    out, counts = {}, {}
    for name, st in (stats or {}).items():
        by_dtype = st.get("dtype_bytes") or {"": st["bytes"]}
        out[name] = int(sum(n * (scale if dt == "float32" else 1.0)
                            for dt, n in by_dtype.items()))
        counts[name] = st["calls"]
    out["total"] = sum(out.values())
    out["counts"] = counts
    return out


def roofline_report(counts: StepCounts, *, hw: HW = HW(),
                    model_flops: float = 0.0, chips: int = 1,
                    stats: dict | None = None, wire: str = "f32",
                    argument_bytes_per_device: int | None = None,
                    output_bytes_per_device: int | None = None) -> dict:
    """The three terms, the bottleneck and the step's lower bound from
    :func:`count_step`'s ``counts`` of the whole step over ``chips``
    devices, and the collectives a device sends (``stats``:
    ``WorkerMesh.read_stats()``; ``wire`` prices their f32 payloads —
    HBM traffic is unchanged, the planes stay f32 in memory).

    ``mem_argument_size_in_bytes`` / ``mem_output_size_in_bytes`` are per
    device: the shard bytes given, or on one device the counted
    arguments and outputs themselves; with several devices and no shard
    bytes the keys are left out. No temporary size is counted, so there
    is no ``mem_temp_size_in_bytes``."""
    flops = counts.flops / chips
    bytes_ = counts.bytes / chips
    coll = collective_bytes(stats, wire=wire)
    compute_s = flops / hw.peak_flops
    memory_s = bytes_ / hw.hbm_bw
    collective_s = coll["total"] / hw.net_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    rep = {
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "wire": wire,
        "collective_bytes_per_device": coll["total"],
        "collective_breakdown": {k: v for k, v in coll.items()
                                 if k not in ("total", "counts")},
        "collective_counts": coll["counts"],
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": bottleneck,
        "step_time_lower_bound_s": max(terms.values()),
    }
    if model_flops:
        rep["model_flops_global"] = model_flops
        rep["useful_flop_fraction"] = (model_flops / counts.flops
                                       if counts.flops else 0.0)
    if argument_bytes_per_device is None and chips == 1:
        argument_bytes_per_device = counts.argument_bytes
    if output_bytes_per_device is None and chips == 1:
        output_bytes_per_device = counts.output_bytes
    if argument_bytes_per_device is not None:
        rep["mem_argument_size_in_bytes"] = int(argument_bytes_per_device)
    if output_bytes_per_device is not None:
        rep["mem_output_size_in_bytes"] = int(output_bytes_per_device)
    return rep


def _shards(tree, specs):
    """(tensor, spec) pairs of ``tree`` and its spec tree (dicts matched
    by key, lists and tuples by position; a spec is a tuple subclass,
    ``PartitionSpec``, whose entries are axis names, tuples of names or
    None)."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _shards(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, sp in zip(tree, specs, strict=True):
            yield from _shards(v, sp)


def _split(spec, mesh_shape: dict) -> int:
    """Over how many devices ``spec`` splits a leaf."""
    div = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                div *= mesh_shape[axis]
    return div


def _shard_numel(t: torch.Tensor, spec, mesh_shape: dict) -> int:
    """Elements one device holds of ``t`` under ``spec``: its distinct
    elements over the devices the spec splits it over, rounded up."""
    return -(-(tensor_bytes(t) // t.element_size())
             // _split(spec, mesh_shape))


def shard_numel(tree, specs, mesh_shape: dict) -> int:
    """Elements one device holds of ``tree`` laid out by ``specs`` (the
    PartitionSpecs ``repro_torch.sharding.specs`` computes for it) over a
    mesh of ``mesh_shape`` (axis -> size): each leaf's distinct elements
    over the product of the axes its spec names, rounded up."""
    return sum(_shard_numel(t, sp, mesh_shape)
               for t, sp in _shards(tree, specs))


def shard_bytes(tree, specs, mesh_shape: dict) -> int:
    """Bytes one device holds of ``tree`` (:func:`shard_numel`'s
    elements at each leaf's element size)."""
    return sum(_shard_numel(t, sp, mesh_shape) * t.element_size()
               for t, sp in _shards(tree, specs))
