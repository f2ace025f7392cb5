"""The kernels' dispatch layer, the counterpart of ``repro.kernels.ops``:
the wrappers the model code calls, re-exported from their modules. Each
launches its CUDA kernel on card tensors and runs its plain version in
``repro_torch.kernels.ref`` on CPU tensors. Importing this module builds
and loads nothing (``_build`` does that on a kernel's first launch).
"""
from repro_torch.kernels.avg_disp import avg_disp, avg_disp_outer  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: F401
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: F401
