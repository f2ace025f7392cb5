"""The port's roofline (``repro_torch.roofline.analysis``) against the
reference's (``repro.roofline.analysis``) on the CPU.

- ``wire_scale`` for the four wire formats, and ``model_flops`` for the
  ten archs x four shapes, equal to the reference's (the port keeps the
  reference's analytic parameter count for 6·N·D);
- ``count_step``: one matmul gives exactly 2MNK flops and its operand and
  result bytes; views and bare allocations move no bytes; a broadcast
  operand counts its distinct elements; the forward and backward of
  smollm-360m reduced at tokens (2, 16) counts within 10% of XLA's
  ``cost_analysis()["flops"]`` for the same step (measured 0.947: XLA
  also counts elementwise flops);
- ``collective_bytes`` prices f32 payloads at the wire and leaves other
  dtypes as they are; ``roofline_report``'s terms, bottleneck, bound and
  memory keys.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.roofline import analysis as jroof  # noqa: E402
from repro_torch.configs import SHAPES as PSHAPES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.flat import tree_flatten  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.roofline import analysis as roof  # noqa: E402

WIRES = ("f32", "bf16", "int8", "one_bit")


@pytest.mark.parametrize("wire", WIRES)
def test_wire_scale_matches_reference(wire):
    assert roof.wire_scale(wire) == jroof.wire_scale(wire)


def test_wire_scale_refuses_unknown_format():
    with pytest.raises(ValueError, match="unknown wire format"):
        roof.wire_scale("fp8")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_matches_reference(arch, shape):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for training in (True, False):
        assert roof.model_flops(cfg, PSHAPES[shape], training=training) \
            == jroof.model_flops(jcfg, SHAPES[shape], training=training)
    assert roof.analytic_active_params(cfg) == jcfg.num_active_params()
    assert roof.analytic_params(cfg) == jcfg.num_params()


@pytest.mark.parametrize("m,k,n,dtype", [(64, 128, 32, torch.bfloat16),
                                         (7, 5, 3, torch.float32),
                                         (1024, 960, 2560, torch.bfloat16)])
def test_count_step_of_one_matmul(m, k, n, dtype):
    a, b = steps.sds((m, k), dtype), steps.sds((k, n), dtype)
    c = roof.count_step(torch.matmul, a, b)
    e = a.element_size()
    assert c.flops == 2 * m * n * k
    assert c.bytes == (m * k + k * n + m * n) * e
    assert c.argument_bytes == (m * k + k * n) * e
    assert c.output_bytes == m * n * e
    assert c.ops == 1


def test_count_step_views_and_broadcasts():
    x = steps.sds((8, 16), torch.float32)
    c = roof.count_step(lambda t: t.view(16, 8).reshape(128)[3:], x)
    assert c.bytes == 0 and c.flops == 0
    # a reshape of a transposed view copies: one read, one write
    c = roof.count_step(lambda t: t.t().reshape(128), x)
    assert c.bytes == 2 * 128 * 4
    row = steps.sds((16,), torch.float32)
    c = roof.count_step(lambda t, r: t + r.expand(8, 16), x, row)
    # x read, the broadcast row read once, the sum written
    assert c.bytes == (128 + 16 + 128) * 4
    c = roof.count_step(lambda t: torch.empty_like(t), x)
    assert c.bytes == 0


def test_counts_scale_and_add():
    a, b = steps.sds((4, 8), torch.float32), steps.sds((8, 2), torch.float32)
    c = roof.count_step(torch.matmul, a, b)
    d = c.scaled(3) + c
    assert d.flops == 4 * c.flops and d.bytes == 4 * c.bytes
    assert d.argument_bytes == c.argument_bytes


@pytest.fixture(scope="module")
def reduced_step_counts():
    cfg = get_config("smollm-360m", reduced=True)
    params = steps.abstract_params(cfg)
    for x in tree_flatten(params)[0]:
        x.requires_grad_(True)
    batch = {"tokens": steps.sds((2, 16), torch.int32)}

    def step(p, b):
        loss, _ = tfm.lm_loss(cfg, p, b)
        loss.backward()
        return loss
    got = roof.count_step(step, params, batch)
    jcfg = jget_config("smollm-360m", reduced=True)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    jb = {"tokens": jnp.zeros((2, 16), jnp.int32)}
    compiled = jax.jit(jax.value_and_grad(
        lambda p: jtfm.lm_loss(jcfg, p, jb)[0])).lower(jp).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return got, float(ca["flops"]), cfg, jcfg


def test_train_step_flops_within_ten_percent_of_xla(reduced_step_counts):
    got, want, _, _ = reduced_step_counts
    assert 0.9 <= got.flops / want <= 1.1, (got.flops, want)


def test_train_step_counts_above_six_nd(reduced_step_counts):
    got, _, cfg, _ = reduced_step_counts
    six_nd = 6 * roof.analytic_active_params(cfg) * 2 * 16
    # 6ND plus the attention scores; params and tokens are read, the
    # gradients written
    assert six_nd < got.flops < 1.2 * six_nd
    assert got.bytes > got.argument_bytes
    assert got.output_bytes == 4  # the f32 loss


@pytest.mark.parametrize("wire", WIRES)
def test_collective_bytes_prices_f32_payloads_at_the_wire(wire):
    stats = {"all_reduce": dict(calls=2, seconds=0.0, bytes=4000,
                                dtype_bytes={"float32": 4000}),
             "all_gather": dict(calls=1, seconds=0.0, bytes=640,
                                dtype_bytes={"float32": 512, "uint8": 128})}
    got = roof.collective_bytes(stats, wire=wire)
    s = jroof.wire_scale(wire)
    assert got["all_reduce"] == int(4000 * s)
    assert got["all_gather"] == int(512 * s + 128)
    assert got["total"] == got["all_reduce"] + got["all_gather"]
    assert got["counts"] == {"all_reduce": 2, "all_gather": 1}
    assert roof.collective_bytes(None, wire=wire) == {"total": 0,
                                                      "counts": {}}


def test_roofline_report_terms():
    c = roof.StepCounts(flops=4e12, bytes=8e10, argument_bytes=100,
                        output_bytes=40)
    hw = roof.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.net_bw) == (989.4e12, 3.35e12,
                                                     50e9)
    stats = {"all_reduce": dict(calls=1, seconds=0.0, bytes=10 ** 9,
                                dtype_bytes={"float32": 10 ** 9})}
    rep = roof.roofline_report(c, chips=4, stats=stats, model_flops=8e12,
                               wire="bf16")
    np.testing.assert_allclose(rep["flops_per_device"], 1e12)
    np.testing.assert_allclose(rep["compute_s"], 1e12 / hw.peak_flops)
    np.testing.assert_allclose(rep["memory_s"], 2e10 / hw.hbm_bw)
    assert rep["collective_bytes_per_device"] == 5 * 10 ** 8
    np.testing.assert_allclose(rep["collective_s"], 5e8 / hw.net_bw)
    assert rep["bottleneck"] == "collective"
    assert rep["step_time_lower_bound_s"] == rep["collective_s"]
    np.testing.assert_allclose(rep["useful_flop_fraction"], 2.0)
    for key in ("mem_argument_size_in_bytes", "mem_output_size_in_bytes",
                "mem_temp_size_in_bytes"):
        assert key not in rep  # no shard bytes given for 4 chips
    one = roof.roofline_report(c)
    assert one["mem_argument_size_in_bytes"] == 100
    assert one["mem_output_size_in_bytes"] == 40
    assert one["bottleneck"] == "memory"
    four = roof.roofline_report(c, chips=4, argument_bytes_per_device=25,
                                output_bytes_per_device=10)
    assert four["mem_argument_size_in_bytes"] == 25
    assert four["mem_output_size_in_bytes"] == 10
    # the reference's keys (its mem_* come from XLA's memory analysis)
    assert set(rep) == {
        "flops_per_device", "bytes_per_device", "wire",
        "collective_bytes_per_device", "collective_breakdown",
        "collective_counts", "compute_s", "memory_s", "collective_s",
        "bottleneck", "step_time_lower_bound_s", "model_flops_global",
        "useful_flop_fraction"}


def test_shard_bytes_divides_by_the_named_axes():
    from repro_torch.sharding.specs import P
    tree = {"a": steps.sds((16, 32), torch.bfloat16),
            "b": [steps.sds((7,), torch.float32)]}
    specs = {"a": P(("pod", "data"), "model"), "b": [P(None)]}
    mesh = {"pod": 2, "data": 2, "model": 4}
    assert roof.shard_bytes(tree, specs, mesh) == 16 * 32 * 2 // 16 + 28
    assert roof.shard_numel(tree, specs, mesh) == 32 + 7
