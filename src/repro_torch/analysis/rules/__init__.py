"""Rule modules self-register on import; importing this package loads all."""

from repro_torch.analysis.rules import (  # noqa: F401
    cache_hygiene,
    checkpoint_ladder,
    eager_validation,
    kernel_twin,
    rng_salt,
    telemetry_sync,
    trace_safety,
)
