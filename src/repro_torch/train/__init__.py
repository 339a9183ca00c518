"""repro_torch.train — the LM train step and the fault-tolerant training
loop (port of ``repro/train``)."""
from .train_step import (TrainConfig, estimate_model_flops, make_train_step,
                         trainable, value_and_grad)
from .trainer import HeartbeatMonitor, LoopConfig, Trainer

__all__ = ["HeartbeatMonitor", "LoopConfig", "TrainConfig", "Trainer",
           "estimate_model_flops", "make_train_step", "trainable",
           "value_and_grad"]
