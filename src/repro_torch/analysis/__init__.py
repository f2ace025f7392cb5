"""repro_torch.analysis: static analysis of the PyTorch/CUDA port.

The counterpart of ``repro.analysis``, on the port's terms. Run from the
repo root::

    PYTHONPATH=src python -m repro_torch.analysis            # text report
    PYTHONPATH=src python -m repro_torch.analysis --format json

or import from tests::

    from repro_torch.analysis import analyze, get_rule, RepoModel

The pass is pure ``ast`` + ``json``: it never imports the code it reads,
nor torch, jax or ``repro``, so it runs where torch is not installed. It
reads the port's files only (``src/repro_torch/``, the port's tests,
``chip_smoke.py`` and ``examples/*_torch.py``). See
``docs/INVARIANTS_TORCH.md`` for the contracts each rule encodes.
"""

from repro_torch.analysis.base import (  # noqa: F401
    Finding,
    Rule,
    all_rules,
    get_rule,
    register,
)
from repro_torch.analysis.baseline import (  # noqa: F401
    BASELINE_NAME,
    load_baseline,
    save_baseline,
)
from repro_torch.analysis.model import RepoModel  # noqa: F401
from repro_torch.analysis.runner import Report, analyze, run_rules  # noqa: F401
