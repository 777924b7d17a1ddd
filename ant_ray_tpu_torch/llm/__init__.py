"""ant_ray_tpu_torch.llm — LLM serving on the port's PyTorch models
(counterpart of ant_ray_tpu.llm): the continuous-batching engine with
dense per-slot KV slabs, bucketed or chunked prefill, batched decode and
session KV offload, and the EngineLoop that steps it on a thread of its
own.
"""

from ant_ray_tpu_torch.llm.engine import EngineLoop, LLMEngine, RequestOutput
from ant_ray_tpu_torch.llm.sampling import SamplingParams
from ant_ray_tpu_torch.llm.tokenizer import ByteTokenizer, get_tokenizer

__all__ = [
    "ByteTokenizer",
    "EngineLoop",
    "LLMEngine",
    "RequestOutput",
    "SamplingParams",
    "get_tokenizer",
]
