"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU and without a card.

- Machinery parity: the same ``Finding.fingerprint``, suppression table,
  baseline bytes, ``split_by_baseline`` result, ``Report`` dict and text,
  and CLI exit codes for the same inputs.
- Rule parity: each fixture pair of ``tests/test_analysis.py`` translated
  to the port's idiom and layout (torch for jnp, ``_build.library`` for
  ``pl.pallas_call``, ``repro_torch.rng.fold_in`` for
  ``jax.random.fold_in``, ``src/repro_torch/...`` paths) gets the
  reference's verdict on the original: the same rule, the same number of
  findings; where a rule's logic is unchanged, the same source text
  through both gives the same messages. Then the port's own cases, each
  pinning a contract or a fix of the rule on the port's terms.
- Mutations of copies of the port's real files, each flagged.
- The real tree: clean against ``analysis-baseline-torch.json``, the
  eight kernels of the reference's ``TWINS`` discovered, the three salted
  streams in the registry, and an import that loads no torch, jax or
  ``repro``.

Nothing here imports torch but the lazy ``resolve_device`` check.
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as R
import repro_torch.analysis as P
from repro.analysis.__main__ import main as ref_cli
from repro.analysis.base import suppressed_rules as ref_suppressed
from repro.analysis.baseline import split_by_baseline as ref_split
from repro.analysis.runner import Report as RefReport
from repro.analysis.runner import run_rules as ref_run_rules
from repro_torch.analysis.__main__ import main as port_cli
from repro_torch.analysis.base import suppressed_rules as port_suppressed
from repro_torch.analysis.baseline import split_by_baseline as port_split
from repro_torch.analysis.runner import Report as PortReport
from repro_torch.analysis.runner import run_rules as port_run_rules

REPO_ROOT = Path(__file__).resolve().parents[1]
RULE_IDS = ("trace-purity", "rng-salt", "kernel-twin", "checkpoint-ladder",
            "eager-validation", "jit-cache-hygiene", "telemetry-host-sync")
ENV = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))


def write_tree(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return root


def ref_findings(root: Path, rule_id: str):
    return ref_run_rules(R.RepoModel.load(root), [R.get_rule(rule_id)])


def port_findings(root: Path, rule_id: str):
    return port_run_rules(P.RepoModel.load(root), [P.get_rule(rule_id)])


# ------------------------------------------------------ (a) machinery parity

FINDING_ARGS = [
    ("trace-purity", "src/a.py", 3, "PhaseEngine._step: `float()` x"),
    ("rng-salt", "src/b.py", 0, "  salt   constant\tduplicates  "),
    ("kernel-twin", "src/k/ref.py", 12, "stale TWINS entry `bar`"),
]


@pytest.mark.parametrize("args", FINDING_ARGS, ids=lambda a: a[0])
def test_fingerprint_and_render_match(args):
    ref, port = R.Finding(*args), P.Finding(*args)
    assert port.fingerprint == ref.fingerprint
    assert port.to_dict() == ref.to_dict()
    assert port.render() == ref.render()


SUPPRESS_LINES = [
    "x = 1",
    "x = 1  # analysis: ignore[trace-purity]",
    "x = 1  # analysis: ignore[trace-purity, rng-salt] -- why",
    "x = 1  #analysis:ignore[*]",
    "x = 1  # analysis: ignore[]",
    "# analysis: ignore[kernel-twin]",
    "x = 1  # analysis: ignore[ kernel-twin ,]",
]


@pytest.mark.parametrize("line", range(1, len(SUPPRESS_LINES) + 2))
def test_suppressed_rules_match(line):
    assert port_suppressed(SUPPRESS_LINES, line) == \
        ref_suppressed(SUPPRESS_LINES, line)


def _finding_pairs():
    return ([R.Finding(*a) for a in FINDING_ARGS],
            [P.Finding(*a) for a in FINDING_ARGS])


def test_save_baseline_bytes_match(tmp_path):
    refs, ports = _finding_pairs()
    just = {refs[0].fingerprint: "kept"}
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    a = R.save_baseline(tmp_path / "r", refs, just)
    b = P.save_baseline(tmp_path / "p", ports, just)
    assert a.name == "analysis-baseline.json"
    assert b.name == "analysis-baseline-torch.json"
    assert a.read_bytes() == b.read_bytes()
    assert P.load_baseline(tmp_path / "p") == R.load_baseline(tmp_path / "r")


def test_unjustified_baseline_entry_refused(tmp_path):
    (tmp_path / P.BASELINE_NAME).write_text(json.dumps({
        "version": 1, "findings": [{"fingerprint": "deadbeefdeadbeef"}]}))
    with pytest.raises(ValueError, match="justification"):
        P.load_baseline(tmp_path)


def test_split_by_baseline_matches():
    refs, ports = _finding_pairs()
    base = {refs[1].fingerprint: "x", "0123456789abcdef": "gone"}
    rn, ra, rs = ref_split(refs, base)
    pn, pa, ps = port_split(ports, base)
    assert [f.to_dict() for f in pn] == [f.to_dict() for f in rn]
    assert [f.to_dict() for f in pa] == [f.to_dict() for f in ra]
    assert ps == rs == ["0123456789abcdef"]


@pytest.mark.parametrize("stale", [False, True])
def test_report_dict_and_text_match(stale):
    refs, ports = _finding_pairs()
    gone = ["0123456789abcdef"] if stale else []
    ref = RefReport(refs, refs[:2], refs[2:], gone, list(RULE_IDS))
    port = PortReport(ports, ports[:2], ports[2:], gone, list(RULE_IDS))
    assert port.to_dict() == ref.to_dict()
    assert port.ok == ref.ok == (not refs[:2] and not stale)
    # the stale line names each pass's own baseline file
    assert port.to_text() == ref.to_text().replace(
        R.BASELINE_NAME, P.BASELINE_NAME)


JIT_BRANCH = """
    import jax

    @jax.jit
    def step(x):
        if x > 0:
            return x
        return -x
"""

JIT_CLEAN = """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step(x):
        return jnp.where(x > 0, x, -x)
"""

STEP_BRANCH = """
    def make_train_step(cfg):
        def train_step(worker_params, opt_state, batch, step):
            if worker_params > 0:
                return worker_params
            return -worker_params
        return train_step
"""

STEP_CLEAN = """
    import torch

    def make_train_step(cfg):
        def train_step(worker_params, opt_state, batch, step):
            return torch.where(worker_params > 0, worker_params,
                               -worker_params)
        return train_step
"""


def _cli_trees(tmp_path, branch: bool):
    ref = write_tree(tmp_path / "ref", {
        "src/repro/foo.py": JIT_BRANCH if branch else JIT_CLEAN})
    port = write_tree(tmp_path / "port", {
        "src/repro_torch/launch/steps.py": STEP_BRANCH if branch
        else STEP_CLEAN})
    return ref, port


def test_cli_exit_codes_match(tmp_path, capsys):
    ref, port = _cli_trees(tmp_path, branch=True)
    rcs = []
    for cli, root in ((ref_cli, ref), (port_cli, port)):
        argv = ["--root", str(root), "--rules", "trace-purity"]
        first = cli(argv + ["--format", "json"])
        out = json.loads(capsys.readouterr().out)
        assert out["counts"]["new"] == 1 and out["ok"] is False
        upd = cli(argv + ["--update-baseline"])
        capsys.readouterr()
        after = cli(argv)
        assert "[baseline]" in capsys.readouterr().out
        rcs.append((first, upd, after))
    assert rcs[1] == rcs[0] == (1, 0, 0)


def test_cli_output_file_matches(tmp_path, capsys):
    ref, port = _cli_trees(tmp_path, branch=False)
    outs = []
    for cli, root in ((ref_cli, ref), (port_cli, port)):
        path = root / "artifacts" / "analysis.json"
        assert cli(["--root", str(root), "--rules", "trace-purity",
                    "--output", str(path)]) == 0
        outs.append(json.loads(path.read_text()))
    capsys.readouterr()
    assert outs[1] == outs[0] and outs[0]["ok"] is True


def test_list_rules_names_the_seven_ids(capsys):
    assert port_cli(["--list-rules"]) == 0
    port_ids = [ln.split(":")[0] for ln in
                capsys.readouterr().out.splitlines()]
    assert ref_cli(["--list-rules"]) == 0
    ref_ids = [ln.split(":")[0] for ln in
               capsys.readouterr().out.splitlines()]
    assert port_ids == ref_ids == sorted(RULE_IDS)


def test_fingerprint_is_line_insensitive(tmp_path):
    write_tree(tmp_path, {"src/repro_torch/launch/steps.py": STEP_BRANCH})
    fp1 = port_findings(tmp_path, "trace-purity")[0].fingerprint
    write_tree(tmp_path, {"src/repro_torch/launch/steps.py":
                          "# pad\n# pad\n" + textwrap.dedent(STEP_BRANCH)})
    assert port_findings(tmp_path, "trace-purity")[0].fingerprint == fp1


# ----------------------------------------------------------- (b) rule parity
# Each case: (id, rule, the reference's count of findings, reference
# tree, port tree, same messages). The reference tree is the fixture of
# tests/test_analysis.py as written there; the port tree is its
# translation (None: the same source text at the port's paths).

KERNEL_TREE = {
    "src/repro/kernels/foo.py": """
        from jax.experimental import pallas as pl

        def _foo_kernel(x_ref, o_ref):
            o_ref[...] = x_ref[...]

        def foo(x, *, block_p=8, interpret=False):
            return pl.pallas_call(_foo_kernel)(x)
    """,
    "src/repro/kernels/ref.py": """
        TWINS = {"foo": "foo_ref"}

        def foo_ref(x):
            return x
    """,
    "tests/test_foo.py": """
        from repro.kernels.foo import foo
        from repro.kernels.ref import foo_ref

        def test_eq():
            assert foo is not foo_ref
    """,
}

PORT_FOO = """
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import foo_ref

    def foo(x, *, block_p=8, interpret=False):
        if x.device.type == "cpu":
            return foo_ref(x)
        return _card_foo(x)

    def _card_foo(x):
        out = torch.empty_like(x)
        _build.check(_foo_launch(x, out), "foo")
        return out

    def _foo_launch(x, out):
        lib = _build.library("foo")
        return lib.foo_launch(x.data_ptr(), out.data_ptr(), x.numel())
"""

PORT_KERNEL_TREE = {
    "src/repro_torch/kernels/foo.py": PORT_FOO,
    "src/repro_torch/kernels/ref.py": KERNEL_TREE["src/repro/kernels/ref.py"],
    "src/repro_torch/kernels/_build.py": """
        import ctypes

        SIGNATURES = {"foo": ("foo_launch", [ctypes.c_void_p])}

        def library(name):
            return ctypes.CDLL(name)

        def check(err, what):
            if err != 0:
                raise RuntimeError(what)
    """,
    "src/repro_torch/kernels/csrc/foo.cu": "// foo_launch\n",
    "src/repro_torch/kernels/card_check.py": """
        from repro_torch.kernels import ref
        from repro_torch.kernels.foo import foo

        def check_foo(x):
            return (foo(x) - ref.foo_ref(x)).abs().max()
    """,
    "tests/test_torch_foo.py": """
        from repro_torch.kernels.foo import foo
        from repro_torch.kernels.ref import foo_ref

        def test_eq():
            assert foo is not foo_ref
    """,
}


def _with(tree: dict, files: dict, drop=()) -> dict:
    """``tree`` with ``files`` written over it and ``drop`` removed."""
    out = {**tree, **files}
    for rel in drop:
        del out[rel]
    return out


REF_SIGNATURE_DRIFT = """
    from jax.experimental import pallas as pl

    def _foo_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    def foo(x, *, alpha=0.5, block_p=8, interpret=False):
        return pl.pallas_call(_foo_kernel)(x)
"""

EMPTY_TWINS = """
    TWINS = {}

    def foo_ref(x):
        return x
"""
TWINS_ONLY = 'TWINS = {"foo": "foo_ref"}\n'
NO_TEST = "def test_nothing():\n    pass\n"

STALE_TWINS = """
    TWINS = {"foo": "foo_ref", "bar": "bar_ref"}

    def foo_ref(x):
        return x

    def bar_ref(x):
        return x
"""

CKPT_TREE = {
    "src/repro/checkpoint/io.py": """
        ENGINE_STATE_VERSION = 2
        _VERSION_KEY = "engine_state_version"
        _OPTIONAL_FIELDS = ("sched",)

        def load_engine_state(path, like_state):
            version = 0
            if version > ENGINE_STATE_VERSION:
                raise ValueError("future version")
            if version == 0:
                return like_state._replace()
            if version == 1:
                return like_state._replace()
            return like_state._replace()
    """,
    "src/repro/core/engine.py": """
        from typing import NamedTuple

        class EngineState(NamedTuple):
            params: tuple
            step: int
            sched: tuple = ()
    """,
    "tests/test_ckpt.py": """
        def test_v0_roundtrip():
            payload = {"engine_state_version": 0}
            assert payload

        def test_v1_roundtrip():
            build_legacy(version=1)

        def build_legacy(version):
            return version
    """,
}
V0_ONLY_TEST = """
    def test_v0_roundtrip():
        payload = {"engine_state_version": 0}
        assert payload
"""


def _ckpt(io=None, test=None) -> dict:
    out = dict(CKPT_TREE)
    if io is not None:
        old, new = io
        out["src/repro/checkpoint/io.py"] = out[
            "src/repro/checkpoint/io.py"].replace(old, new)
    if test is not None:
        out["tests/test_ckpt.py"] = test
    return out


def _to_port(tree: dict) -> dict:
    """The same source text at the port's paths (``tests/test_x.py`` ->
    ``tests/test_torch_x.py``)."""
    out = {}
    for rel, text in tree.items():
        rel = rel.replace("src/repro/", "src/repro_torch/")
        if rel.startswith("tests/test_"):
            rel = "tests/test_torch_" + rel[len("tests/test_"):]
        out[rel] = text
    return out


HYGIENE_CONFTEST = """
    import jax
    import pytest

    @pytest.fixture(autouse=True, scope="module")
    def _release_compiled_executables():
        yield
        jax.clear_caches()
"""

TELE_METRICS_OK = """
    import jax.numpy as jnp
    import numpy as np

    FLUSH_FUNCTIONS = ("flush_metrics",)

    def accumulate(acc, loss):
        return acc + jnp.asarray(loss)

    def flush_metrics(vec):
        v = np.asarray(vec)
        return {"loss": float(v[0]), "steps": int(v[1])}
"""

PORT_METRICS_OK = """
    import numpy as np
    import torch

    FLUSH_FUNCTIONS = ("flush_metrics",)

    def accumulate(acc, loss):
        return acc + torch.as_tensor(loss)

    def flush_metrics(vec):
        v = np.asarray(vec)
        return {"loss": float(v[0]), "steps": int(v[1])}
"""

REF_METRICS = "src/repro/telemetry/metrics.py"
PORT_METRICS = "src/repro_torch/telemetry/metrics.py"
REF_EXTRA = "src/repro/telemetry/extra.py"
PORT_EXTRA = "src/repro_torch/telemetry/extra.py"


def _rng_pair(salt_a: str, salt_b: str, consts: str):
    ref = f"""
        import jax

        {consts}

        def a(key, step):
            return jax.random.fold_in(jax.random.fold_in(key, {salt_a}), step)

        def b(key, step):
            return jax.random.fold_in(jax.random.fold_in(key, {salt_b}), step)
    """
    port = f"""
        from repro_torch import rng

        {consts}

        def a(key, step):
            return rng.fold_in(rng.fold_in(key, {salt_a}), step)

        def b(key, step):
            return rng.fold_in(rng.fold_in(key, {salt_b}), step)
    """
    return ref, port


RNG_COLLIDE = _rng_pair("_SALT", "_SALT", "_SALT = 7")
RNG_DISTINCT = _rng_pair("_A_SALT", "_B_SALT",
                         "_A_SALT = 7\n        _B_SALT = 8")

PARITY_CASES = [
    # trace-purity
    ("tp-branch", "trace-purity", 1, {"src/repro/foo.py": JIT_BRANCH},
     {"src/repro_torch/launch/steps.py": STEP_BRANCH}, False),
    ("tp-clean", "trace-purity", 0, {"src/repro/foo.py": JIT_CLEAN},
     {"src/repro_torch/launch/steps.py": STEP_CLEAN}, False),
    ("tp-scan-body-coercion", "trace-purity", 1, {"src/repro/foo.py": """
        import jax

        def run(xs):
            def body(c, x):
                c = c + float(x)
                return c, c
            return jax.lax.scan(body, 0.0, xs)
    """}, {"src/repro_torch/core/engine.py": """
        class PhaseEngine:
            def _step(self, state, batch, grads_fn, gbuf):
                c = state.plane + float(batch)
                return state, c
    """}, False),
    ("tp-static-args", "trace-purity", 0, {"src/repro/foo.py": """
        from functools import partial
        import jax

        @partial(jax.jit, static_argnames=("k",))
        def step(x, k):
            if k:
                return x + 1
            return x
    """}, {"src/repro_torch/launch/steps.py": """
        def make_train_step(cfg):
            def train_step(worker_params, opt_state, batch, step):
                if step:
                    return worker_params + 1
                return worker_params
            return train_step
    """}, False),
    ("tp-numpy-and-impure", "trace-purity", 2, {"src/repro/foo.py": """
        import time
        import numpy as np
        import jax

        @jax.jit
        def step(x):
            t = time.time()
            return np.asarray(x) * t
    """}, {"src/repro_torch/launch/steps.py": """
        import time
        import numpy as np

        def make_prefill_step(cfg):
            def prefill_step(params, batch):
                t = time.time()
                return np.asarray(params) * t
            return prefill_step
    """}, False),
    ("tp-interprocedural", "trace-purity", 1, {"src/repro/foo.py": """
        import jax

        def helper(y):
            assert y > 0
            return y

        @jax.jit
        def step(x):
            return helper(x)
    """}, {"src/repro_torch/launch/steps.py": """
        def helper(y):
            assert y > 0
            return y

        def make_prefill_step(cfg):
            def prefill_step(params, batch):
                return helper(params)
            return prefill_step
    """}, False),
    ("tp-suppressed", "trace-purity", 0, {"src/repro/foo.py": JIT_BRANCH.replace(
        "if x > 0:", "if x > 0:  # analysis: ignore[trace-purity] -- fixture")},
     {"src/repro_torch/launch/steps.py": STEP_BRANCH.replace(
         "if worker_params > 0:", "if worker_params > 0:  "
         "# analysis: ignore[trace-purity] -- fixture")}, False),
    ("tp-wrong-rule-suppression", "trace-purity", 1,
     {"src/repro/foo.py": JIT_BRANCH.replace(
         "if x > 0:", "if x > 0:  # analysis: ignore[rng-salt]")},
     {"src/repro_torch/launch/steps.py": STEP_BRANCH.replace(
         "if worker_params > 0:",
         "if worker_params > 0:  # analysis: ignore[rng-salt]")}, False),
    # rng-salt
    ("rng-colliding-streams", "rng-salt", 1,
     {"src/repro/foo.py": RNG_COLLIDE[0]},
     {"src/repro_torch/foo.py": RNG_COLLIDE[1]}, False),
    ("rng-distinct-salts", "rng-salt", 0,
     {"src/repro/foo.py": RNG_DISTINCT[0]},
     {"src/repro_torch/foo.py": RNG_DISTINCT[1]}, False),
    ("rng-duplicate-salt-constants", "rng-salt", 1,
     {"src/repro/a.py": "_GOSSIP_SALT = 5\n", "src/repro/b.py":
      "_ENC_SALT = 5\n"}, None, True),
    ("rng-key-reuse-after-split", "rng-salt", 1, {"src/repro/foo.py": """
        import jax

        def f(key):
            k1, k2 = jax.random.split(key)
            return jax.random.normal(key, (2,))
    """}, {"src/repro_torch/foo.py": """
        from repro_torch import rng

        def f(key):
            k1, k2 = rng.split(key)
            return rng.normal(key, (2,))
    """}, False),
    ("rng-rebound-key", "rng-salt", 0, {"src/repro/foo.py": """
        import jax

        def f(key):
            key, sub = jax.random.split(key)
            return jax.random.normal(sub, (2,))
    """}, {"src/repro_torch/foo.py": """
        from repro_torch import rng

        def f(key):
            key, sub = rng.split(key)
            return rng.normal(sub, (2,))
    """}, False),
    # kernel-twin
    ("kt-complete", "kernel-twin", 0, KERNEL_TREE, PORT_KERNEL_TREE, False),
    ("kt-unregistered", "kernel-twin", 1, _with(
        KERNEL_TREE, {"src/repro/kernels/ref.py": EMPTY_TWINS}),
     _with(PORT_KERNEL_TREE, {"src/repro_torch/kernels/ref.py": EMPTY_TWINS}),
     False),
    ("kt-deleted-twin", "kernel-twin", 1, _with(
        KERNEL_TREE, {"src/repro/kernels/ref.py": TWINS_ONLY}),
     _with(PORT_KERNEL_TREE, {"src/repro_torch/kernels/ref.py": TWINS_ONLY}),
     False),
    ("kt-signature-drift", "kernel-twin", 1, _with(
        KERNEL_TREE, {"src/repro/kernels/foo.py": REF_SIGNATURE_DRIFT}),
     _with(PORT_KERNEL_TREE, {"src/repro_torch/kernels/foo.py": PORT_FOO.
           replace("def foo(x, *,", "def foo(x, *, alpha=0.5,")}), False),
    ("kt-missing-equivalence-test", "kernel-twin", 1, _with(
        KERNEL_TREE, {"tests/test_other.py": NO_TEST},
        drop=("tests/test_foo.py",)),
     _with(PORT_KERNEL_TREE, {"tests/test_torch_other.py": NO_TEST},
           drop=("tests/test_torch_foo.py",)), False),
    ("kt-stale-twins-entry", "kernel-twin", 1, _with(
        KERNEL_TREE, {"src/repro/kernels/ref.py": STALE_TWINS}),
     _with(PORT_KERNEL_TREE, {"src/repro_torch/kernels/ref.py": STALE_TWINS}),
     False),
    # checkpoint-ladder: the rule's logic is the reference's
    ("ckpt-complete", "checkpoint-ladder", 0, CKPT_TREE, None, True),
    ("ckpt-deleted-branch", "checkpoint-ladder", 1, _ckpt(io=(
        "            if version == 1:\n"
        "                return like_state._replace()\n", "")), None, True),
    ("ckpt-missing-future-guard", "checkpoint-ladder", 1, _ckpt(io=(
        "            if version > ENGINE_STATE_VERSION:\n"
        "                raise ValueError(\"future version\")\n", "")),
     None, True),
    ("ckpt-optional-fields-drift", "checkpoint-ladder", 1, _ckpt(io=(
        '_OPTIONAL_FIELDS = ("sched",)',
        '_OPTIONAL_FIELDS = ("sched", "resid")')), None, True),
    ("ckpt-untested-version", "checkpoint-ladder", 1, _ckpt(test=V0_ONLY_TEST),
     None, True),
    # eager-validation: the rule's logic is the reference's
    ("eager-validating", "eager-validation", 0,
     {"src/repro/core/averaging.py": """
        class AveragingSchedule:
            def __post_init__(self):
                if self.period <= 0:
                    raise ValueError("period must be positive")
     """}, None, True),
    ("eager-missing", "eager-validation", 1, {"src/repro/core/averaging.py": """
        class AveragingSchedule:
            def __post_init__(self):
                self.warmup = 0
    """}, None, True),
    ("eager-parser-error", "eager-validation", 0,
     {"src/repro/launch/train.py": """
        import argparse

        def main():
            ap = argparse.ArgumentParser()
            args = ap.parse_args()
            if args.workers < 1:
                ap.error("need at least one worker")
     """}, None, True),
    # jit-cache-hygiene
    ("hyg-respected", "jit-cache-hygiene", 0, {
        "tests/conftest.py": HYGIENE_CONFTEST, "tests/test_ok.py": """
            import jax

            def test_ok():
                f = jax.jit(lambda x: x)
                assert f is not None
        """}, {
        "tests/conftest.py": HYGIENE_CONFTEST, "tests/test_torch_ok.py": """
            import torch

            def test_ok():
                x = torch.zeros(2, device="cuda")
                assert x is not None
        """}, False),
    ("hyg-missing-fixture", "jit-cache-hygiene", 1, {
        "tests/conftest.py": "import jax\n",
        "tests/test_ok.py": "def test_ok():\n    pass\n"}, None, True),
    ("hyg-import-time-work", "jit-cache-hygiene", 1, {
        "tests/conftest.py": HYGIENE_CONFTEST, "tests/test_leak.py": """
            import jax

            f = jax.jit(lambda x: x)

            def test_leak():
                assert f is not None
        """}, {
        "tests/conftest.py": HYGIENE_CONFTEST, "tests/test_torch_leak.py": """
            from repro_torch.kernels import _build

            lib = _build.library("avg_disp")

            def test_leak():
                assert lib is not None
        """}, False),
    ("hyg-ad-hoc-clear", "jit-cache-hygiene", 1, {
        "tests/conftest.py": HYGIENE_CONFTEST, "tests/test_adhoc.py": """
            import jax

            def test_adhoc():
                jax.clear_caches()
        """}, None, True),
    # telemetry-host-sync
    ("tele-flush-exempt", "telemetry-host-sync", 0,
     {REF_METRICS: TELE_METRICS_OK}, {PORT_METRICS: PORT_METRICS_OK}, False),
    ("tele-coercion-outside-flush", "telemetry-host-sync", 1, {
        REF_METRICS: TELE_METRICS_OK, REF_EXTRA: """
            import jax

            def peek(acc):
                return float(acc[0])
        """}, {PORT_METRICS: PORT_METRICS_OK, PORT_EXTRA: """
            import torch

            def peek(acc):
                return float(acc[0])
        """}, False),
    ("tele-item-and-host-copy", "telemetry-host-sync", 2, {
        REF_METRICS: TELE_METRICS_OK, REF_EXTRA: """
            import jax

            def peek(acc):
                return jax.device_get(acc), acc[0].item()
        """}, {PORT_METRICS: PORT_METRICS_OK, PORT_EXTRA: """
            import torch

            def peek(acc):
                return acc.cpu(), acc[0].item()
        """}, False),
    ("tele-numpy-materializer", "telemetry-host-sync", 1, {
        REF_METRICS: TELE_METRICS_OK, REF_EXTRA: """
            import jax.numpy as jnp
            import numpy as np

            def fold(acc):
                return jnp.asarray(acc) + 1  # on-device: legal

            def leak(acc):
                return np.asarray(acc)
        """}, {PORT_METRICS: PORT_METRICS_OK, PORT_EXTRA: """
            import numpy as np
            import torch

            def fold(acc):
                return torch.as_tensor(acc) + 1  # on-device: legal

            def leak(acc):
                return np.asarray(acc)
        """}, False),
    ("tele-module-without-framework", "telemetry-host-sync", 0, {
        REF_METRICS: TELE_METRICS_OK, "src/repro/telemetry/report.py": """
            import json

            def render(path):
                return float(json.loads(path)["loss"])
        """}, {PORT_METRICS: PORT_METRICS_OK,
               "src/repro_torch/telemetry/report.py": """
            import json

            def render(path):
                return float(json.loads(path)["loss"])
        """}, False),
    ("tele-missing-registry", "telemetry-host-sync", 1, {REF_METRICS: """
        import jax.numpy as jnp

        def accumulate(acc):
            return acc
    """}, None, True),
    ("tele-stale-registry", "telemetry-host-sync", 1, {REF_METRICS: """
        import jax.numpy as jnp

        FLUSH_FUNCTIONS = ("flush_metrics", "gone")

        def flush_metrics(vec):
            return float(vec[0])
    """}, None, True),
]


@pytest.mark.parametrize("rule,n,ref_tree,port_tree,same",
                         [c[1:] for c in PARITY_CASES],
                         ids=[c[0] for c in PARITY_CASES])
def test_rule_verdict_matches_reference(tmp_path, rule, n, ref_tree,
                                        port_tree, same):
    if port_tree is None:
        port_tree = _to_port(ref_tree)
    ref = ref_findings(write_tree(tmp_path / "ref", ref_tree), rule)
    port = port_findings(write_tree(tmp_path / "port", port_tree), rule)
    assert len(ref) == n, ref
    assert [f.rule for f in port] == [f.rule for f in ref], (ref, port)
    if same:
        assert [f.message.replace("src/repro/", "src/repro_torch/")
                for f in ref] == [f.message for f in port]


# ----------------------------------------- (b') the rules on the port's terms

def _engine_step(body: str) -> dict:
    return {"src/repro_torch/core/engine.py": "import numpy as np\n"
            "import torch\n\n\nclass PhaseEngine:\n"
            "    def _step(self, state, batch, grads_fn, gbuf):\n"
            + textwrap.indent(textwrap.dedent(body), " " * 8)}


@pytest.mark.parametrize("body,needle", [
    ("return state.plane.sum().item()\n", "`.item()`"),
    ("return state.plane.tolist()\n", "`.tolist()`"),
    ("return state.plane.cpu()\n", "`.cpu()`"),
    ("torch.cuda.synchronize()\nreturn state\n", "torch.cuda.synchronize"),
    ("while state.plane.any():\n    pass\nreturn state\n", "`while`"),
    ("print(batch)\nreturn state\n", "impure call"),
    ("return np.array(state.plane)\n", "np.*"),
], ids=["item", "tolist", "cpu", "synchronize", "while", "print", "np"])
def test_trace_purity_flags_host_syncs_at_engine_roots(tmp_path, body,
                                                       needle):
    write_tree(tmp_path, _engine_step(body))
    found = port_findings(tmp_path, "trace-purity")
    assert len(found) == 1 and needle in found[0].message, found
    assert found[0].message.startswith("PhaseEngine._step: ")


@pytest.mark.parametrize("body", [
    # host metadata of a tensor, and the host fields of the state
    "m, p = state.plane.shape\nif p % 2 or state.plane.numel() == 0:\n"
    "    return state\nif state.step > 3 and state.fault:\n    return state\n"
    "return state\n",
    # a host read is flagged once; what follows on the host is not
    "d = float(state.plane.sum())  # analysis: ignore[trace-purity]\n"
    "if d > 1.0:\n    return state\nreturn state\n",
    # zip / enumerate unpack element by element: host specs stay host
    "for spec, p in zip(self.specs, state.plane):\n"
    "    if spec.cross:\n        pass\n"
    "for i, row in enumerate(state.plane):\n    if i > 1:\n        pass\n"
    "return state\n",
], ids=["metadata", "host-read-once", "zip-enumerate"])
def test_trace_purity_host_values_pass(tmp_path, body):
    write_tree(tmp_path, _engine_step(body))
    assert port_findings(tmp_path, "trace-purity") == []


def test_trace_purity_tuple_returns_taint_by_element(tmp_path):
    write_tree(tmp_path, {"src/repro_torch/core/engine.py": """
        class PhaseEngine:
            def _host_and_tensor(self, state):
                return state.plane * 2, 0.5, state.step

            def _step(self, state, batch, grads_fn, gbuf):
                plane, scale, step = self._host_and_tensor(state)
                if scale > 0.1 and step:
                    plane = plane * scale
                if plane.sum() > 0:
                    return state
                return state
    """})
    found = port_findings(tmp_path, "trace-purity")
    assert len(found) == 1 and "`plane.sum() > 0`" in found[0].message


CARD_PATH = """
    import torch

    from repro_torch.kernels import _build

    def _card_foo(x, *, groups, codes, alive):
        if groups > 1 and alive is not None:
            pass
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("x")
        err = _foo_launch(x, codes)
        _build.check(err, "foo")
        return x

    def _foo_launch(x, codes):
        lib = _build.library("foo")
        return lib.foo_launch(x.data_ptr(), codes.data_ptr())
"""

BUILD_WITH_TIMING = """
    import time

    def library(name):
        t0 = time.perf_counter()
        return t0

    def check(err, what):
        if err != 0:
            raise RuntimeError(what)
"""


def test_trace_purity_card_paths_are_roots(tmp_path):
    """Positional and tensor keyword-only parameters of ``_card_*`` /
    ``*_launch`` are tensors, the rest launch configuration; a launch's
    error code is a host int and the library loader is not followed."""
    write_tree(tmp_path, {
        "src/repro_torch/kernels/foo.py": CARD_PATH,
        "src/repro_torch/kernels/_build.py": BUILD_WITH_TIMING})
    assert port_findings(tmp_path, "trace-purity") == []
    write_tree(tmp_path, {"src/repro_torch/kernels/foo.py": CARD_PATH.replace(
        "        return x\n", "        return codes.sum().item()\n")})
    found = port_findings(tmp_path, "trace-purity")
    assert len(found) == 1 and "_card_foo: `.item()`" in found[0].message


def test_trace_purity_tree_flatten_leaves_are_a_host_container(tmp_path):
    write_tree(tmp_path, {
        "src/repro_torch/core/flat.py": """
            def tree_flatten(tree):
                return list(tree), None

            class FlatOptSpec:
                @classmethod
                def of(cls, param, opt_state):
                    leaves, treedef = tree_flatten(opt_state)
                    if not leaves:
                        return None
                    return cls()
        """,
        "src/repro_torch/launch/steps.py": """
            from repro_torch.core.flat import FlatOptSpec

            def make_train_step(cfg):
                def train_step(worker_params, opt_state, batch, step):
                    spec = FlatOptSpec.of(None, opt_state)
                    if spec is None or spec.num_planes:
                        return worker_params
                    return worker_params
                return train_step
        """})
    assert port_findings(tmp_path, "trace-purity") == []


def test_rng_salt_resolves_the_ports_rng(tmp_path):
    """``rng.fold_in`` through ``from repro_torch import rng`` and
    ``import repro_torch.rng as rng``, and the rng module's own draws,
    are streams; ``jax.random`` in a port file is not the port's."""
    write_tree(tmp_path, {
        "src/repro_torch/a.py": """
            import repro_torch.rng as rng

            _X_SALT = 3

            def a(key, step):
                return rng.fold_in(rng.fold_in(key, _X_SALT), step)
        """,
        "src/repro_torch/b.py": """
            from repro_torch import rng
            from repro_torch.a import _X_SALT

            def b(key, step):
                return rng.fold_in(rng.fold_in(key, _X_SALT), step)
        """,
        "src/repro_torch/rng.py": """
            def split(key, num=2):
                return key

            def fold_in(key, data):
                return key

            def draw(key):
                k1, k2 = split(key)
                return fold_in(key, 1)
        """,
        "src/repro_torch/c.py": """
            import jax

            def c(key, step):
                return jax.random.fold_in(jax.random.fold_in(key, 3), step)
        """})
    found = port_findings(tmp_path, "rng-salt")
    msgs = sorted(f.message for f in found)
    assert len(found) == 2, msgs
    assert any("collides with src/repro_torch/a.py:a" in m for m in msgs)
    assert any("raw key `key` used after `rng.split(key)`" in m
               for m in msgs)
    from repro_torch.analysis.rules.rng_salt import registry
    sites = registry(P.RepoModel.load(tmp_path))
    assert {s.mod.rel for s in sites} == {
        "src/repro_torch/a.py", "src/repro_torch/b.py",
        "src/repro_torch/rng.py"}


@pytest.mark.parametrize("drop,needle", [
    ("signatures", "no entry in kernels/_build.py SIGNATURES"),
    ("source", "no source kernels/csrc/foo.cu"),
    ("card_check", "nothing holds it against its twin on the card"),
], ids=["signatures", "source", "card-check"])
def test_kernel_twin_port_checks(tmp_path, drop, needle):
    tree = dict(PORT_KERNEL_TREE)
    if drop == "signatures":
        tree["src/repro_torch/kernels/_build.py"] = tree[
            "src/repro_torch/kernels/_build.py"].replace(
            '"foo": ("foo_launch", [ctypes.c_void_p])', "")
    elif drop == "source":
        tree.pop("src/repro_torch/kernels/csrc/foo.cu")
    else:
        tree["src/repro_torch/kernels/card_check.py"] = """
            from repro_torch.kernels.foo import foo

            def check_foo(x):
                return foo(x)
        """
    write_tree(tmp_path, tree)
    found = port_findings(tmp_path, "kernel-twin")
    assert len(found) == 1 and needle in found[0].message, found


def test_kernel_twin_discovers_through_same_module_calls(tmp_path):
    from repro_torch.analysis.rules.kernel_twin import discover_kernels
    tree = dict(PORT_KERNEL_TREE)
    tree["src/repro_torch/kernels/foo.py"] = PORT_FOO + """
    def foo_plain(x):
        return x

    def _foo_helper(x):
        return _card_foo(x)
"""
    write_tree(tmp_path, tree)
    names = {n for _, n, _ in discover_kernels(P.RepoModel.load(tmp_path))}
    assert names == {"foo"}


def test_hygiene_skip_markers_pass_card_work_flagged(tmp_path):
    write_tree(tmp_path, {
        "tests/conftest.py": HYGIENE_CONFTEST,
        "tests/test_torch_marked.py": """
            import pytest
            import torch

            pytestmark = pytest.mark.skipif(
                not torch.cuda.is_available() or torch.cuda.device_count() < 1,
                reason="needs a card")
        """,
        "tests/test_torch_work.py": """
            import torch
            from repro_torch.kernels import _build

            X = torch.zeros(4, device="cuda:0")
            Y = torch.ones(4).cuda()
            _build.build_all()
            torch.cuda.synchronize()
        """})
    found = port_findings(tmp_path, "jit-cache-hygiene")
    assert {f.path for f in found} == {"tests/test_torch_work.py"}
    assert len(found) == 4


def test_checkpoint_ladder_takes_parametrized_version_ids(tmp_path):
    tree = _to_port(_ckpt(test="""
        import pytest

        @pytest.mark.parametrize("how", ["v0", "adamw-v1"])
        def test_roundtrip(how):
            assert "engine_state_version"
    """))
    write_tree(tmp_path, tree)
    assert port_findings(tmp_path, "checkpoint-ladder") == []


def test_scan_set_is_the_ports_files(tmp_path):
    write_tree(tmp_path, {
        "src/repro/core/engine.py": "x = 1\n",
        "src/repro_torch/core/engine.py": "y = 1\n",
        "tests/test_analysis.py": "z = 1\n",
        "tests/test_torch_a.py": "z = 1\n",
        "tests/torch_parity.py": "z = 1\n",
        "tests/conftest.py": "z = 1\n",
        "chip_smoke.py": "z = 1\n",
        "examples/quickstart.py": "z = 1\n",
        "examples/quickstart_torch.py": "z = 1\n",
        "benchmarks/bench.py": "z = 1\n"})
    model = P.RepoModel.load(tmp_path)
    assert sorted(model.modules) == [
        "chip_smoke.py", "examples/quickstart_torch.py",
        "src/repro_torch/core/engine.py", "tests/conftest.py",
        "tests/test_torch_a.py", "tests/torch_parity.py"]
    assert model.find("core/engine.py").rel == \
        "src/repro_torch/core/engine.py"
    assert [m.rel for m in model.src_modules()] == [
        "src/repro_torch/core/engine.py"]


# --------------------------------------- (c) mutations of the port's files

@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    """A copy of the port's scan set (and the kernels' sources)."""
    root = tmp_path_factory.mktemp("port_tree")
    shutil.copytree(REPO_ROOT / "src" / "repro_torch",
                    root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    (root / "tests").mkdir()
    for path in [*REPO_ROOT.glob("tests/test_torch_*.py"),
                 REPO_ROOT / "tests" / "torch_parity.py",
                 REPO_ROOT / "tests" / "torch_sharded_worker.py",
                 REPO_ROOT / "tests" / "conftest.py"]:
        shutil.copy(path, root / "tests" / path.name)
    shutil.copy(REPO_ROOT / "analysis-baseline-torch.json", root)
    return root


def _mutate(src: Path, dst: Path, rel: str, fn) -> Path:
    shutil.copytree(src, dst)
    path = dst / rel
    text = path.read_text()
    new = fn(text)
    assert new != text, f"mutation of {rel} changed nothing"
    path.write_text(new)
    return dst


def _drop_lines(text: str, start: str, stop: str) -> str:
    """``text`` without the lines from the one starting with ``start`` up
    to (not including) the next one starting with ``stop``."""
    lines = text.splitlines(keepends=True)
    i = next(k for k, ln in enumerate(lines) if ln.startswith(start))
    j = next(k for k in range(i + 1, len(lines))
             if lines[k].startswith(stop))
    return "".join(lines[:i] + lines[j:])


def _no_raises_in_class(text: str, cls: str) -> str:
    tree = ast.parse(text)

    class Strip(ast.NodeTransformer):
        def visit_Raise(self, node):
            return ast.Pass()

    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            Strip().visit(node)
    return ast.unparse(tree) + "\n"


MUTATIONS = {
    "twins-entry-deleted": (
        "src/repro_torch/kernels/ref.py",
        lambda t: t.replace('    "rglru_scan": "rglru_scan_ref",\n', ""),
        "kernel-twin", "`rglru_scan` has no TWINS entry"),
    "signatures-entry-dropped": (
        "src/repro_torch/kernels/_build.py",
        lambda t: _drop_lines(t, '    "mix_disp": (', '    "avg_disp_outer"'),
        "kernel-twin", "library `mix_disp`, which has no entry"),
    "card-check-sweep-removed": (
        "src/repro_torch/kernels/card_check.py",
        lambda t: _drop_lines(t, "def check_rglru(", "def serve_sweep("),
        "kernel-twin", "names kernel `rglru_scan` together"),
    "v3-loader-branch-deleted": (
        "src/repro_torch/checkpoint/io.py",
        lambda t: _drop_lines(t, "    elif version == 3:",
                              "    elif version == 4:"),
        "checkpoint-ladder", "no loader branch for layout version 3"),
    "faultplan-raises-removed": (
        "src/repro_torch/faults.py",
        lambda t: _no_raises_in_class(t, "FaultPlan"),
        "eager-validation", "entry point `FaultPlan` performs no eager"),
    "salt-value-duplicated": (
        "src/repro_torch/core/compress.py",
        lambda t: t.replace("_ENC_SALT = 0x656E63", "_ENC_SALT = 0x676F73"),
        "rng-salt", "0x676f73 duplicates"),
    "telemetry-item-outside-flush": (
        "src/repro_torch/telemetry/timing.py",
        lambda t: t + "\n\ndef _peek(acc):\n    return acc.item()\n",
        "telemetry-host-sync", "`.item()` is a host round-trip"),
    "test-module-level-synchronize": (
        "tests/test_torch_rng.py",
        lambda t: t + "\ntorch.cuda.synchronize()\n",
        "jit-cache-hygiene", "import-time card work"),
}


def test_port_copy_is_clean(port_tree):
    report = P.analyze(port_tree)
    assert report.ok, report.to_text()


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_mutation_flagged(port_tree, tmp_path, name):
    rel, fn, rule, needle = MUTATIONS[name]
    root = _mutate(port_tree, tmp_path / "m", rel, fn)
    report = P.analyze(root, rules=[P.get_rule(rule)])
    assert any(needle in f.message for f in report.new), report.to_text()


# ---------------------------------------------------------- (d) the real tree

@pytest.fixture(scope="module")
def real_model():
    return P.RepoModel.load(REPO_ROOT)


def test_real_tree_is_clean():
    report = P.analyze(REPO_ROOT)
    assert report.ok, report.to_text()
    assert report.rules == sorted(RULE_IDS)


def _ref_twins_keys() -> set:
    tree = ast.parse((REPO_ROOT / "src/repro/kernels/ref.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "TWINS":
            return set(ast.literal_eval(node.value))
    raise AssertionError("the reference's ref.py has no TWINS")


def test_real_kernels_are_the_reference_twins_keys(real_model):
    from repro_torch.analysis.rules.kernel_twin import (_twins_table,
                                                        discover_kernels)
    names = {n for _, n, _ in discover_kernels(real_model)}
    keys = _ref_twins_keys()
    assert len(keys) == 8 and names == keys
    _, table = _twins_table(real_model.find("kernels/ref.py"))
    assert set(table) == keys
    assert table["compressed_mix"] == ["compressed_avg_ref",
                                       "compressed_mix_ref"]


def test_real_rng_registry_holds_the_three_salted_streams(real_model):
    from repro_torch.analysis.rules.rng_salt import registry
    heads = {}
    for s in registry(real_model):
        for el in s.chain:
            if isinstance(el, tuple) and el[0] == "const":
                heads.setdefault(el[1], set()).add(s.mod.rel)
    assert heads[0x676F73] == {"src/repro_torch/topology.py"}
    assert heads[0x656E63] == {"src/repro_torch/core/compress.py"}
    assert heads[0x737472] == {"src/repro_torch/faults.py"}
    salts = {name: real_model.resolve_constant(real_model.find(rel), name)
             for rel, name in (("topology.py", "_GOSSIP_SALT"),
                               ("core/compress.py", "_ENC_SALT"),
                               ("faults.py", "_STRAGGLE_SALT"))}
    assert salts == {"_GOSSIP_SALT": 0x676F73, "_ENC_SALT": 0x656E63,
                     "_STRAGGLE_SALT": 0x737472}


def test_real_baseline_entries_are_justified():
    data = json.loads((REPO_ROOT / P.BASELINE_NAME).read_text())
    assert data["findings"]
    for e in data["findings"]:
        assert "TODO" not in e["justification"]
        assert "ROADMAP.md" in e["justification"], e


def test_analysis_imports_no_torch_jax_or_reference():
    code = ("import sys\nimport repro_torch.analysis\n"
            "import repro_torch.analysis.__main__\n"
            "bad = sorted(n for n in sys.modules if n in ('torch', 'jax', "
            "'repro', 'numpy') or n.startswith(('torch.', 'jax.', "
            "'repro.')))\nprint('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_cli_on_the_real_tree():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--format", "json"], env=ENV, cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout)
    assert report["ok"] is True and report["counts"]["new"] == 0
    assert report["counts"]["stale_baseline"] == 0


def test_resolve_device_still_importable_from_the_package():
    pytest.importorskip("torch")
    from repro_torch import resolve_device
    assert resolve_device("cpu").type == "cpu"
