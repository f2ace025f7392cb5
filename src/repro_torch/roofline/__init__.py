from repro_torch.roofline.analysis import (  # noqa: F401
    HW,
    StepCounts,
    collective_bytes,
    count_step,
    model_flops,
    roofline_report,
    wire_scale,
)
