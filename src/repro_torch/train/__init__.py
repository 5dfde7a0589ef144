"""Training: AdamW, the train step, checkpoints, the balancer loop."""
from . import checkpoint, optimizer, trainer
from .trainer import TrainConfig, Trainer, make_train_step

__all__ = ["checkpoint", "optimizer", "trainer", "TrainConfig", "Trainer",
           "make_train_step"]
