"""Client optimizers and learning-rate schedules."""
from repro_torch.optim import schedules
from repro_torch.optim.sgd import ClientOpt

__all__ = ["ClientOpt", "schedules"]
