from .convert import (lora_pool_from_numpy, params_from_numpy,
                      train_state_from_numpy)
from .gpt import GPTConfig, GPTForCausalLM, gpt
from .llama import (LlamaConfig, LlamaForCausalLM, PRESETS, causal_lm_loss,
                    llama)

__all__ = ["GPTConfig", "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM",
           "PRESETS", "causal_lm_loss", "gpt", "llama",
           "lora_pool_from_numpy", "params_from_numpy",
           "train_state_from_numpy"]
