"""ant_ray_tpu_torch.train — the training step on the port's PyTorch
models, Llama and GPT-2 (counterpart of the JAX package's train step in
bench.py): next-token loss, autograd through the hand-written flash
kernels, AdamW.
"""

from ant_ray_tpu_torch.train.step import make_optimizer, train_step

__all__ = ["make_optimizer", "train_step"]
