from .base import ArchConfig, get_config, all_configs, ASSIGNED
__all__ = ["ArchConfig", "get_config", "all_configs", "ASSIGNED"]
