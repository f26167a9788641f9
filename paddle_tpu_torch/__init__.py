"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100.

The JAX package ``paddle_tpu`` beside it is the reference; this package
never imports it (nor JAX).  Module layout and names follow the
reference, so each module has a counterpart: ``models/llama.py``,
``serving/engine.py``, ``incubate/nn/functional.py``, ...  Every Pallas
kernel on the ported path is a hand-written CUDA kernel for sm_90a under
``csrc/`` (``ops/cuda`` binds them).  Entry points run on the card unless
the caller passes ``device="cpu"``; on CPU tensors each kernel wrapper
runs its plain PyTorch version.

Ported so far: Llama and GPT serving through the paged ragged
``serving.Engine`` step and the paged bucket-prefill/decode model path,
their dense-cache ``generate()`` (the decode step captured once into a
CUDA graph on the card; :func:`seed` resets its random stream), and
Llama training through ``jit.TrainStep`` with ``optimizer.AdamW``,
``nn.ClipGradByGlobalNorm`` and ``amp.decorate`` at O2 (ROADMAP.md lists
what is still to port).
"""

from .core.device import resolve_device
from .core.random import seed

__version__ = "0.1.0"

__all__ = ["resolve_device", "seed", "__version__"]
