from .convert import params_from_numpy
from .llama import LlamaConfig, LlamaForCausalLM, PRESETS, llama

__all__ = ["LlamaConfig", "LlamaForCausalLM", "PRESETS", "llama",
           "params_from_numpy"]
