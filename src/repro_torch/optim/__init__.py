from repro_torch.optim.adamw import AdamW
from repro_torch.optim.sgd import SGD, Momentum, schedules

__all__ = ["AdamW", "Momentum", "SGD", "schedules"]
