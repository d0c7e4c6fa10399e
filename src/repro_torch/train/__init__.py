"""LM training around the model's train step: the loop with
checkpoint/restart, failure injection and a straggler watchdog
(``trainer``), checkpoints in the JAX package's format (``checkpoint``)
and int8 error-feedback gradient compression (``compression``)."""
from .trainer import Trainer, TrainerConfig
from . import checkpoint, compression

__all__ = ["Trainer", "TrainerConfig", "checkpoint", "compression"]
