"""The port's training loop (``repro.train`` on PyTorch): the functional
train step and the fault-tolerant ``Trainer``."""
from repro_torch.train.train_step import make_grad_fn, make_opt_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "make_grad_fn", "make_opt_state", "make_train_step"]
