from repro_torch.core.averaging import AveragingSchedule, SchedState
from repro_torch.core.engine import EngineState, PhaseEngine, make_plane_step
from repro_torch.core.flat import FlatOptSpec, FlatSpec

__all__ = ["AveragingSchedule", "EngineState", "FlatOptSpec", "FlatSpec",
           "PhaseEngine", "SchedState", "make_plane_step"]
