from repro_torch.core.averaging import AveragingSchedule, SchedState
from repro_torch.core.engine import EngineState, PhaseEngine, make_plane_step
from repro_torch.core.flat import FlatOptSpec, FlatSpec
from repro_torch.core.theory import (lemma1_asymptotic_variance,
                                     simulate_quadratic)
from repro_torch.core.variance_model import (measure_beta2, measure_sigma2,
                                             predict_averaging_benefit,
                                             predict_post_resize_dispersion,
                                             rho)

__all__ = ["AveragingSchedule", "EngineState", "FlatOptSpec", "FlatSpec",
           "PhaseEngine", "SchedState", "lemma1_asymptotic_variance",
           "make_plane_step", "measure_beta2", "measure_sigma2",
           "predict_averaging_benefit", "predict_post_resize_dispersion",
           "rho", "simulate_quadratic"]
