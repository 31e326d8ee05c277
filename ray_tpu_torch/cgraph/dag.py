"""Bind-style DAG authoring surface for compiled graphs.

Mirrors the reference's accelerated-DAG authoring API (ref:
python/ray/dag/ — ``InputNode``, ``actor.method.bind(...)``,
``MultiOutputNode``, ``dag.experimental_compile()``): a DAG is declared
once over live ActorHandles, then compiled into persistent per-actor
execution loops fed by pre-allocated channels (see compiled.py).

    with InputNode() as inp:
        x = stage_a.fwd.bind(inp)
        x = stage_b.fwd.bind(x)
        dag = stage_c.fwd.bind(x)
    compiled = dag.experimental_compile()
    out = compiled.execute(batch).get()
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """Base: a node in a statically-declared dataflow graph."""

    def experimental_compile(self, channel_bytes: Optional[int] = None,
                             max_inflight: int = 16,
                             codec: Optional[str] = None):
        """Compile the graph rooted at this output node. See
        ``CompiledDAG`` for the execution surface. ``codec``
        ("int8"/"e4m3", docs/COLLECTIVES.md) block-quantizes large
        float arrays in every edge payload — lossy, ~1/4 the channel
        bytes; error/seq semantics unchanged."""
        from .compiled import compile_dag

        return compile_dag(self, channel_bytes=channel_bytes,
                           max_inflight=max_inflight, codec=codec)

    def _upstream(self) -> List["DAGNode"]:
        return []


class InputNode(DAGNode):
    """Placeholder for the value passed to ``compiled.execute(x)``.

    Usable bare (``inp = InputNode()``) or as a context manager, matching
    the reference's ``with InputNode() as inp:`` idiom. Exactly one
    InputNode may appear in a graph; pass a tuple/dict through it when a
    stage needs several values.
    """

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __repr__(self) -> str:
        return "InputNode()"


class ClassMethodNode(DAGNode):
    """``actor.method.bind(*args, **kwargs)`` — one actor-method call in
    the static graph. Args/kwargs may be other DAGNodes (dataflow edges)
    or plain values (constants, serialized once at compile time).
    ``ActorMethod.options(num_returns=, concurrency_group=)`` carries
    through ``bind()`` exactly as it does through ``remote()``."""

    def __init__(self, handle, method_name: str, args: Tuple,
                 kwargs: Dict[str, Any], num_returns: int = 1,
                 concurrency_group: str = ""):
        self._handle = handle
        self._method_name = method_name
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs)
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def _upstream(self) -> List[DAGNode]:
        ups = [a for a in self._bound_args if isinstance(a, DAGNode)]
        ups += [v for v in self._bound_kwargs.values()
                if isinstance(v, DAGNode)]
        return ups

    def __repr__(self) -> str:
        return (f"ClassMethodNode({self._handle._description}."
                f"{self._method_name})")


class MultiOutputNode(DAGNode):
    """Bundle several terminal nodes; ``execute().get()`` returns their
    results as a list in declaration order."""

    def __init__(self, outputs: List[DAGNode]):
        if not outputs or not all(isinstance(o, DAGNode) for o in outputs):
            raise TypeError(
                "MultiOutputNode takes a non-empty list of DAGNodes")
        self._outputs = list(outputs)

    def _upstream(self) -> List[DAGNode]:
        return list(self._outputs)

    def __repr__(self) -> str:
        return f"MultiOutputNode({len(self._outputs)} outputs)"


def topological_nodes(root: DAGNode) -> List[DAGNode]:
    """All nodes reachable upstream of ``root``, topologically sorted
    (producers before consumers). Cycles raise — a static graph is a DAG."""
    order: List[DAGNode] = []
    state: Dict[int, int] = {}  # id -> 0 visiting, 1 done
    keep: Dict[int, DAGNode] = {}

    def visit(node: DAGNode) -> None:
        nid = id(node)
        st = state.get(nid)
        if st == 1:
            return
        if st == 0:
            raise ValueError("cycle detected in DAG — compiled graphs "
                             "must be acyclic")
        state[nid] = 0
        keep[nid] = node
        for up in node._upstream():
            visit(up)
        state[nid] = 1
        order.append(node)

    visit(root)
    return order
