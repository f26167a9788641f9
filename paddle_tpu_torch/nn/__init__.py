from . import functional, quant
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers import Embedding, LayerNorm, Linear

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Embedding", "LayerNorm", "Linear", "functional", "quant"]
