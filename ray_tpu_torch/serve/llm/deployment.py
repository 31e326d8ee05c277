"""LLMServer — the serving face of the engine (counterpart of
ray_tpu/serve/llm/deployment.py), as a plain callable: the serve control
plane (controller, handles, proxies) is not ported yet.

    from ray_tpu_torch.serve.llm import LLMServer

    server = LLMServer("gpt2-small", engine_config={"max_batch": 8,
                                                   "prefix_cache": True})
    out = server({"tokens": [1, 5, 9], "max_tokens": 16})
    for tok in server({"tokens": [1, 5, 9], "max_tokens": 16,
                       "stream": True}): ...
    server.shutdown()

Entry points run on the CUDA card unless ``device="cpu"`` is passed. With
``engine_config={"tp": n}`` (n > 1, after ``ray_tpu_torch.init()``) the
engine's n rank actors each build their own shard from the seeded init
(``SeededShards``): the driver never holds the full weights and they
never cross the object store.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..._device import DeviceLike, resolve_device
from ...models import GPT, GPTConfig, Llama, LlamaConfig
from .engine import EngineConfig, LLMEngine

# registry name -> (family, config preset, config overrides)
_TINY = dict(dtype=torch.float32, use_flash=False)
_REGISTRY = {
    "gpt-tiny": ("gpt", "tiny", _TINY),
    "llama-tiny": ("llama", "tiny", _TINY),
    "gpt2-small": ("gpt", "small", {}),
    "llama2-7b": ("llama", "llama2_7b", {}),
}
_FAMILIES = {"gpt": (GPT, GPTConfig), "llama": (Llama, LlamaConfig)}


def _make_model(model: Any = "llama-tiny") -> Any:
    """The model object (no params) for a registry name or dict spec, as
    ``build_model`` describes them."""
    if isinstance(model, str):
        if model not in _REGISTRY:
            raise ValueError(f"unknown model {model!r}; "
                             f"known: {sorted(_REGISTRY)}")
        family, preset, kw = _REGISTRY[model]
    else:
        kw = dict(model)
        family = kw.pop("family")
        preset = kw.pop("preset", "tiny")
    if family not in _FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    cls, config_cls = _FAMILIES[family]
    return cls(getattr(config_cls, preset)(**kw))


def _serving_dtypes(m, params):
    """Llama serves its matmul weights in the compute dtype; GPT keeps
    f32 and casts per product."""
    return m.cast_matmul_weights(params) if isinstance(m, Llama) else params


def build_model(model: Any = "llama-tiny", seed: int = 0,
                device: DeviceLike = None) -> Tuple[Any, Dict]:
    """-> (model, params) on ``device`` (None = the CUDA card). ``model``
    is a registry name ("gpt-tiny", "llama-tiny", "gpt2-small",
    "llama2-7b"), or a dict {"family": "gpt"|"llama", "preset": ...,
    **config_kwargs} for explicit sizing (preset "tiny" when absent).
    Params initialize from ``seed`` with a torch.Generator on the device.
    GPT keeps its params in f32 and casts per product, as the JAX model
    does; Llama stores its matmul weights in the compute dtype
    (Llama.cast_matmul_weights)."""
    dev = resolve_device(device)
    m = _make_model(model)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return m, _serving_dtypes(m, m.init(gen))


@dataclass(frozen=True)
class SeededShards:
    """Params for the tp engine's ranks on ``device``: ``(tp_model) ->``
    this rank's shard of ``build_model``'s params of the same seed, drawn
    one full tensor at a time (the same generator draws, each full tensor
    cut, cast as ``build_model`` casts it and freed before the next)."""
    seed: int = 0
    device: str = "cuda"

    def __call__(self, model) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        out = {}
        for name, full in model.init_items(gen):
            out.update(_serving_dtypes(
                model, {name: model.shard_param(name, full)}))
        return out


class LLMServer:
    """Callable wrapping an LLMEngine whose scheduler runs on a background
    thread from construction until ``shutdown()``."""

    def __init__(self, model: Any = "llama-tiny",
                 engine_config: Optional[Dict[str, Any]] = None,
                 seed: int = 0, name: str = "",
                 device: DeviceLike = None):
        cfg = EngineConfig(**(engine_config or {}))
        if cfg.tp > 1:
            m = _make_model(model)
            params = SeededShards(seed, str(resolve_device(device)))
        else:
            m, params = build_model(model, seed=seed, device=device)
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
        """Stop the scheduler thread and any tp rank actors
        (idempotent)."""
        self.engine.shutdown(timeout=timeout)
