"""The port's kernels: the training path's ``opt_step.opt_step`` and the
averaging events of ``avg_disp``, and the serving path's
``flash_attention.flash_attention``, ``rglru_scan.rglru_scan`` and
``rwkv6_scan.rwkv6_scan`` (CUDA on the card, their plain versions in
``ref`` on the CPU). Nothing here builds or loads CUDA code at import
time; ``_build`` does that on first launch."""
