from . import functional, quant
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers import Embedding, Linear

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Embedding", "Linear", "functional", "quant"]
