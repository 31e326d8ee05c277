"""ray_tpu_torch.train — training engines of the port (counterpart of the
pipeline engines of ray_tpu/train).

So far: the compiled-graph pipeline engine (``CompiledPipelineEngine``,
1F1B and interleaved 1F1B over stage actors, the ZeRO-sharded dp update,
checkpoints and recovery), its single-process reference
``run_reference_1f1b``, ``reshard_checkpoint``, and the older dynamic
engine ``PipelineEngine`` (one ``.remote()`` call per op). The Train
runtime (trainers, sessions, the backend executor) is not ported.
"""
from .pipeline_cgraph import (CompiledPipelineEngine, reshard_checkpoint,
                              run_reference_1f1b)
from .pipeline_engine import PipelineEngine

__all__ = ["CompiledPipelineEngine", "PipelineEngine", "reshard_checkpoint",
           "run_reference_1f1b"]
