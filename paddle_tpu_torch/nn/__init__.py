from . import functional
from .layers import Embedding, Linear

__all__ = ["Embedding", "Linear", "functional"]
