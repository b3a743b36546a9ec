from .decode import Server, ServeConfig
__all__ = ["Server", "ServeConfig"]
