"""fastertransformer4codefuse_tpu — an inference framework in JAX with the
capabilities of codefuse-ai/FasterTransformer4CodeFuse, built from scratch on
JAX / XLA / Pallas, running on NVIDIA GPUs.

Capability map (reference -> here):
  GPT-NeoX CUDA engine            -> models.gptneox + engine.GptNeoXEngine
  CUTLASS fpA-intB int8 GEMM      -> ops.linear (XLA int8-convert GEMM)
  TRT fused MHA / masked-MHA      -> ops.attention (cuDNN) / ops.flash_decode (Pallas, Triton)
  DynamicDecodeLayer              -> sampling.processors + sampling.sample + sampling.beam
  NCCL tensor/pipeline parallel   -> parallel.sharding + GSPMD shardings (NCCL)
  HF converter / int8 quantizer   -> ckpt.convert / ckpt.quantize
  pybind streaming callback       -> engine streaming mode (host token taps)
  CodeFuseHandler / Trie / detok  -> api.handler / api.trie / api.detok
"""

from .core.config import GptNeoXConfig, RuntimeConfig
from .engine.batcher import ContinuousBatcher
from .engine.engine import GenerationOutput, GptNeoXEngine
from .engine.spec_pool import SpecPool
from .engine.speculative import speculative_generate, speculative_generate_batched
from .models.params import QuantizedTensor, init_params, cast_params

__version__ = "0.1.0"

__all__ = [
    "GptNeoXConfig",
    "RuntimeConfig",
    "GptNeoXEngine",
    "GenerationOutput",
    "QuantizedTensor",
    "init_params",
    "cast_params",
    "ContinuousBatcher",
    "SpecPool",
    "speculative_generate",
    "speculative_generate_batched",
]
