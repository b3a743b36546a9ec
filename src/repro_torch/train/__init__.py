from .trainer import Trainer, TrainerConfig
from . import checkpoint
__all__ = ["Trainer", "TrainerConfig", "checkpoint"]
