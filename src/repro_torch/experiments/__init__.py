"""The paper's experiments on the port: Figures 1-3, Table 1, Lemma 1 and
the §2.4 quartic, one module each (``fig1_pca``, ``fig2_convex``,
``fig3_cnn``, ``table1``, ``lemma1``, ``quartic``), the counterparts of
the reference's ``benchmarks/bench_*.py`` with their functions' names,
arguments, defaults and return shapes, and ``device=`` (the card by
default).

    python -m repro_torch.experiments [--device cpu]     # all six
    python -m repro_torch.experiments.<name> [--device cpu]

Each prints the reference's ``name,us_per_call,derived`` line and writes
``results/bench_<name>_torch.json``.
"""
