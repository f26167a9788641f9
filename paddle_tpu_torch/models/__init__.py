from .convert import (lora_pool_from_numpy, params_from_numpy,
                      train_state_from_numpy)
from .llama import (LlamaConfig, LlamaForCausalLM, PRESETS, causal_lm_loss,
                    llama)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "PRESETS", "causal_lm_loss",
           "llama", "lora_pool_from_numpy", "params_from_numpy",
           "train_state_from_numpy"]
