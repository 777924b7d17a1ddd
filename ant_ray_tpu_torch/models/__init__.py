"""Models: the Llama family (serving and training) and the GPT-2 family
(training and forward), and weight conversion from the JAX package's
numpy pytrees."""

from ant_ray_tpu_torch.models import gpt2, llama
from ant_ray_tpu_torch.models.gpt2 import Gpt2Config
from ant_ray_tpu_torch.models.llama import LlamaConfig

__all__ = ["Gpt2Config", "LlamaConfig", "gpt2", "llama"]
