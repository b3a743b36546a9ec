from .pipeline import DataConfig, SyntheticLM, prefetch
__all__ = ["DataConfig", "SyntheticLM", "prefetch"]
