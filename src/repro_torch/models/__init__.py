from .model import build_model, param_count
__all__ = ["build_model", "param_count"]
