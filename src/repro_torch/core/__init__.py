from repro_torch.core.averaging import (AveragingSchedule, OuterOptimizer,
                                        SchedState, average_all,
                                        average_inner, worker_dispersion)
from repro_torch.core.engine import (EngineState, PhaseEngine, consensus,
                                     make_plane_step, make_worker_step,
                                     replicate, tree_stack, unreplicate)
from repro_torch.core.flat import FlatOptSpec, FlatSpec
from repro_torch.core.local_sgd import LocalSGD
from repro_torch.core.theory import (lemma1_asymptotic_variance,
                                     simulate_quadratic)
from repro_torch.core.variance_model import (measure_beta2, measure_sigma2,
                                             predict_averaging_benefit,
                                             predict_post_resize_dispersion,
                                             rho)

__all__ = ["AveragingSchedule", "EngineState", "FlatOptSpec", "FlatSpec",
           "LocalSGD", "OuterOptimizer", "PhaseEngine", "SchedState",
           "average_all", "average_inner", "consensus",
           "lemma1_asymptotic_variance", "make_plane_step",
           "make_worker_step", "measure_beta2", "measure_sigma2",
           "predict_averaging_benefit", "predict_post_resize_dispersion",
           "replicate", "rho", "simulate_quadratic", "tree_stack",
           "unreplicate", "worker_dispersion"]
