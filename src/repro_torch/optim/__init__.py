from .adamw import AdamWConfig, init_state, apply_updates
from . import schedules
__all__ = ["AdamWConfig", "init_state", "apply_updates", "schedules"]
