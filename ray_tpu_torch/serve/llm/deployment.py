"""LLMServer — the serving face of the engine (counterpart of
ray_tpu/serve/llm/deployment.py), as a plain callable: the serve control
plane (controller, handles, proxies) is not ported yet.

    from ray_tpu_torch.serve.llm import LLMServer

    server = LLMServer("llama2-7b", engine_config={"max_batch": 8})
    out = server({"tokens": [1, 5, 9], "max_tokens": 16})
    for tok in server({"tokens": [1, 5, 9], "max_tokens": 16,
                       "stream": True}): ...
    server.shutdown()

Entry points run on the CUDA card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..._device import DeviceLike, resolve_device
from ...models import Llama, LlamaConfig
from .engine import EngineConfig, LLMEngine

# registry name -> (LlamaConfig preset, config overrides)
_REGISTRY = {
    "llama-tiny": ("tiny", dict(dtype=torch.float32, use_flash=False)),
    "llama2-7b": ("llama2_7b", {}),
}


def build_model(model: str = "llama-tiny", seed: int = 0,
                device: DeviceLike = None) -> Tuple[Llama, Dict]:
    """-> (model, params) on ``device`` (None = the CUDA card) for a
    registry name ("llama-tiny", "llama2-7b"). Params initialize from
    `seed` with a torch.Generator on the device; the matmul weights are
    stored in the config's compute dtype (Llama.cast_matmul_weights)."""
    dev = resolve_device(device)
    if model not in _REGISTRY:
        raise ValueError(f"unknown model {model!r}; "
                         f"known: {sorted(_REGISTRY)}")
    preset, kw = _REGISTRY[model]
    m = Llama(getattr(LlamaConfig, preset)(**kw))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return m, m.cast_matmul_weights(m.init(gen))


class LLMServer:
    """Callable wrapping an LLMEngine whose scheduler runs on a background
    thread from construction until ``shutdown()``."""

    def __init__(self, model: str = "llama-tiny",
                 engine_config: Optional[Dict[str, Any]] = None,
                 seed: int = 0, name: str = "",
                 device: DeviceLike = None):
        m, params = build_model(model, seed=seed, device=device)
        cfg = EngineConfig(**(engine_config or {}))
        self.engine = LLMEngine(m, params, cfg, name=name or "serve")
        self.engine.start()

    # -- request path ---------------------------------------------------------

    def __call__(self, payload: Dict[str, Any]):
        """payload: {"tokens": [ints], "max_tokens": n, "eos_id": id?,
        "stream": bool?}. stream=True returns a token generator; otherwise
        the full completion dict."""
        if not isinstance(payload, dict) or "tokens" not in payload:
            raise ValueError("payload must be a dict with 'tokens'")
        stream = self.engine.add_request(
            payload["tokens"], int(payload.get("max_tokens", 16)),
            eos_id=payload.get("eos_id", "__default__"))
        if payload.get("stream"):
            return self._stream_tokens(stream)
        t0 = time.perf_counter()
        toks = stream.tokens()
        return {"request_id": stream.request_id, "tokens": toks,
                "finish_reason": stream.finish_reason,
                "gen_s": round(time.perf_counter() - t0, 4)}

    @staticmethod
    def _stream_tokens(stream):
        for tok in stream:
            yield tok

    # -- control --------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the scheduler thread (idempotent)."""
        self.engine.stop(timeout=timeout)
