"""The port's kernels: ``opt_step.opt_step`` and ``avg_disp.avg_disp``
(CUDA on the card, their plain versions in ``ref`` on the CPU). Nothing
here builds or loads CUDA code at import time; ``_build`` does that on
first launch."""
