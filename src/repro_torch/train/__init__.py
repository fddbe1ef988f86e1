"""Training: the train-step factory (:mod:`.step`)."""
from .step import init_train_state, make_train_step

__all__ = ["init_train_state", "make_train_step"]
