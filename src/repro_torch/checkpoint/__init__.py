"""Checkpoints of params trees and of the engine state."""
from repro_torch.checkpoint.io import (ENGINE_STATE_VERSION, load_checkpoint,
                                       load_engine_state, save_checkpoint,
                                       save_engine_state)

__all__ = ["ENGINE_STATE_VERSION", "load_checkpoint", "load_engine_state",
           "save_checkpoint", "save_engine_state"]
