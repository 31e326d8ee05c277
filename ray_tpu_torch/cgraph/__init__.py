"""ray_tpu_torch.cgraph — compiled graphs (accelerated DAGs).

Statically-declared dataflow over actors, compiled once into resident
per-actor execution loops fed by pre-allocated single-slot channels:
shared-memory segments for same-host edges, the worker RPC path across
nodes. Steady-state ``execute()`` bypasses the entire
submit→schedule→lease→RPC→put→get task pipeline — the execution shape
MPMD pipeline-parallel training and stage-to-stage serving need.

    import ray_tpu_torch
    from ray_tpu_torch.cgraph import InputNode

    with InputNode() as inp:
        dag = stage_b.fwd.bind(stage_a.fwd.bind(inp))
    compiled = dag.experimental_compile()
    try:
        out = compiled.execute(batch).get()
    finally:
        compiled.teardown()

See docs/COMPILED_GRAPHS.md for the channel design, failure semantics,
and benchmark numbers.
"""
from .compiled import CGraphRef, CompiledDAG, compile_dag
from .dag import ClassMethodNode, DAGNode, InputNode, MultiOutputNode

__all__ = [
    "InputNode", "MultiOutputNode", "DAGNode", "ClassMethodNode",
    "CompiledDAG", "CGraphRef", "compile_dag",
]
