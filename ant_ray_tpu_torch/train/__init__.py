"""ant_ray_tpu_torch.train — the Llama training step on the port's
PyTorch model (counterpart of the JAX package's train step in bench.py):
next-token loss, autograd through the hand-written flash kernels, AdamW.
"""

from ant_ray_tpu_torch.train.step import make_optimizer, train_step

__all__ = ["make_optimizer", "train_step"]
