"""``python -m repro_torch.experiments [--device cpu]``: the six
experiments in the order of the reference's ``benchmarks/run.py``, the
CSV header and one line each; exits 1 naming the ones that failed."""
from __future__ import annotations

import sys
import traceback

from repro_torch.experiments import (fig1_pca, fig2_convex, fig3_cnn, lemma1,
                                     quartic, table1)
from repro_torch.experiments.common import parse_device

EXPERIMENTS = (
    ("lemma1 (paper §2.3)", lemma1),
    ("table1 (paper Table 1)", table1),
    ("fig2 convex (paper Fig 2)", fig2_convex),
    ("fig1 pca (paper Fig 1)", fig1_pca),
    ("quartic (paper §2.4)", quartic),
    ("fig3 cnn (paper Fig 3 / §3.2)", fig3_cnn),
)


def main(argv=None) -> None:
    device = str(parse_device(argv, description=__doc__.split("\n")[0]))
    print("name,us_per_call,derived")
    failed = []
    for label, mod in EXPERIMENTS:
        try:
            mod.run(device=device)
        except Exception:
            failed.append(label)
            traceback.print_exc()
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
