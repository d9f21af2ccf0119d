"""Optimizers, the train step and the supervised training loop (the port
of ``repro.train``)."""
from repro_torch.train.optimizer import Optimizer, make_optimizer
from repro_torch.train.step import make_train_step

__all__ = ["Optimizer", "make_optimizer", "make_train_step"]
