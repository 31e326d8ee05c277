"""ray_tpu_torch.serve.llm — continuous-batching LLM serving (counterpart
of ray_tpu.serve.llm): the block pool (kv_cache.py), the iteration-level
scheduler with preemption-and-requeue (engine.py) and the LLMServer
callable (deployment.py)."""
from .deployment import LLMServer, build_model
from .engine import EngineConfig, LLMEngine, Request, TokenStream
from .kv_cache import BlockPool, blocks_for_tokens

__all__ = [
    "BlockPool", "EngineConfig", "LLMEngine", "LLMServer", "Request",
    "TokenStream", "blocks_for_tokens", "build_model",
]
