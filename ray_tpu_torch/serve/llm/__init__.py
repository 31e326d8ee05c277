"""ray_tpu_torch.serve.llm — continuous-batching LLM serving (counterpart
of ray_tpu/serve/llm): the block pool (kv_cache.py), the radix prefix
cache (prefix_cache.py), the iteration-level scheduler with
preemption-and-requeue (engine.py), the LLMServer callable
(deployment.py) and disaggregated prefill/decode over a compiled graph
(disagg.py)."""
from .deployment import LLMServer, build_model
from .disagg import DecodeStage, DisaggLLM, PrefillStage
from .engine import EngineConfig, LLMEngine, Request, TokenStream
from .kv_cache import BlockPool, blocks_for_tokens
from .prefix_cache import PrefixCache, PrefixMatch

__all__ = [
    "BlockPool", "DecodeStage", "DisaggLLM", "EngineConfig", "LLMEngine",
    "LLMServer", "PrefillStage", "PrefixCache", "PrefixMatch", "Request",
    "TokenStream", "blocks_for_tokens", "build_model",
]
