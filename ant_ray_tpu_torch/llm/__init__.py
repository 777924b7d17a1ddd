"""ant_ray_tpu_torch.llm — LLM serving on the port's PyTorch models
(counterpart of ant_ray_tpu.llm): the continuous-batching engine with
dense per-slot KV slabs, bucketed or chunked prefill, batched decode and
session KV offload, the EngineLoop that steps it on a thread of its own,
LLMServer, the OpenAI-shaped front end over both, and the batch
processors over Datasets (llm/batch.py).
"""

from ant_ray_tpu_torch.llm.batch import (build_llm_processor,
                                         build_logprob_processor)
from ant_ray_tpu_torch.llm.engine import EngineLoop, LLMEngine, RequestOutput
from ant_ray_tpu_torch.llm.sampling import SamplingParams
from ant_ray_tpu_torch.llm.serve_llm import LLMServer
from ant_ray_tpu_torch.llm.tokenizer import ByteTokenizer, get_tokenizer

__all__ = [
    "ByteTokenizer",
    "EngineLoop",
    "LLMEngine",
    "LLMServer",
    "RequestOutput",
    "SamplingParams",
    "build_llm_processor",
    "build_logprob_processor",
    "get_tokenizer",
]
