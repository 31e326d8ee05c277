"""Explicit collectives between actors and tasks (counterpart of
ray_tpu/parallel/collective.py, copied with its names and behaviour).

Host-side equivalent of the reference's `ray.util.collective`
(ref: python/ray/util/collective/collective.py:258-615 — allreduce/reduce/
broadcast/allgather/reducescatter/send/recv; GroupManager :40; rendezvous
via a named store actor, collective_group/nccl_util + gloo). It is the
host plane, implemented over the object store with a named rendezvous
actor: the pipeline engine's ZeRO update (``parallel/zero.py``) and its
replicated dp update sync gradients over it.

Contributions are numpy arrays or torch CPU tensors; each collective
returns the kind it was given (a tensor on the card is moved to the CPU
by its caller: the object store carries host bytes). Every collective
that moves tensors accepts ``codec=`` — a block-scaled wire codec
(``"int8"`` / ``"e4m3"``, ``parallel/quant.py``): each rank quantizes its
contribution BEFORE it crosses the wire (per block absmax scales,
deterministic rounding; the payload bytes equal the JAX package's on the
same values) and every reduction runs over the dequantized fp32 values,
so accumulation precision is full even when the wire carries ~1/4 of the
bytes. ``codec=None`` (default) ships the values as they are. Bytes
shipped per op are counted in ``ray_tpu_collective_bytes_total{op,codec}``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch

from ..util import metrics as _metrics
from . import quant as _quant

_C_BYTES = _metrics.Counter(
    "ray_tpu_collective_bytes_total",
    "bytes this process shipped into host collectives (the rank's "
    "wire contribution per op, after any codec)",
    tag_keys=("op", "codec"))

_NUMPY_OPS = {"sum": np.add, "product": np.multiply,
              "max": np.maximum, "min": np.minimum}
_TORCH_OPS = {"sum": "add", "product": "mul", "max": "maximum",
              "min": "minimum"}


def _reduce(xs: List[Any], op: str) -> Any:
    """Fold the rank-ordered contributions with ``op``: torch's function
    for tensors, numpy's for arrays, so the result keeps their kind."""
    if _quant._is_tensor(xs[0]):
        import torch

        fn = getattr(torch, _TORCH_OPS[op])
    else:
        fn = _NUMPY_OPS[op]
    out = xs[0]
    for x in xs[1:]:
        out = fn(out, x)
    return out


class _CollectiveStore:
    """Named rendezvous actor: one per group. Ranks deposit contributions
    keyed by (op sequence number, rank); readers block-poll until the op's
    row is complete. Mirrors the reference's NamedActor store rendezvous
    (ref: util/collective/collective_group/base_collective_group.py)."""

    def __init__(self, world_size: int):
        self._world = world_size
        self._slots: Dict[int, Dict[int, Any]] = {}
        self._p2p: Dict[tuple, Any] = {}

    def put(self, seq: int, rank: int, value):
        self._slots.setdefault(seq, {})[rank] = value
        return True

    def gather(self, seq: int) -> Optional[List[Any]]:
        row = self._slots.get(seq)
        if row is None or len(row) < self._world:
            return None
        return [row[r] for r in range(self._world)]

    def present(self, seq: int) -> List[int]:
        """Ranks that have deposited for ``seq`` — the timeout
        diagnostic surface (which ranks a wedged sync is missing)."""
        return sorted(self._slots.get(seq, {}))

    def done(self, seq: int, rank: int):
        """Each rank acks after consuming; last ack frees the row."""
        row = self._slots.get(seq)
        if row is not None:
            acks = self._slots.setdefault(-seq - 1, {})
            acks[rank] = True
            if len(acks) >= self._world:
                self._slots.pop(seq, None)
                self._slots.pop(-seq - 1, None)
        return True

    def p2p_put(self, seq: int, src: int, dst: int, value):
        self._p2p[(seq, src, dst)] = value
        return True

    def p2p_take(self, seq: int, src: int, dst: int):
        return self._p2p.pop((seq, src, dst), _MISSING)


_MISSING = "__rtpu_missing__"
# contributions at least this large travel by reference: put once into the
# object store by their rank and read from it by each peer, instead of
# passing through the rendezvous actor twice (in its put, out in every
# gather reply)
_BY_REF_BYTES = 1 << 20


class _ByRef:
    """A contribution deposited as an ObjectRef (wrapped, so the store
    actor keeps the reference and never resolves the value)."""

    __slots__ = ("ref",)

    def __init__(self, ref):
        self.ref = ref
# Process-global registry: a worker process holds one rank per group, but
# actor tasks may execute on different threads (executor pool), so the
# registry must not be thread-local.
_GROUPS: Dict[str, "CollectiveGroup"] = {}


class CollectiveGroup:
    """Per-process view of a collective group (rank-local state)."""

    def __init__(self, group_name: str, world_size: int, rank: int):
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self._seq = 0
        store_cls = ray_tpu_torch.remote(_CollectiveStore)
        # num_cpus=0: the store is a pure rendezvous point and must schedule
        # even on a fully-subscribed cluster (ranks hold all the CPUs while
        # they block in _exchange).
        # Name scoped by world_size so re-creating a group with a different
        # size can never attach to a stale store left by the old group.
        self._store_name = f"rtpu_collective:{group_name}:{world_size}"
        self._store = store_cls.options(
            name=self._store_name,
            get_if_exists=True, lifetime="detached", num_cpus=0,
            max_concurrency=max(8, world_size * 2),
        ).remote(world_size)

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _exchange(self, value, timeout: float = 120.0,
                  op: str = "exchange",
                  codec: Optional[str] = None) -> List[Any]:
        seq = self._next_seq()
        _C_BYTES.inc(_quant.wire_bytes(value),
                     tags={"op": op, "codec": codec or "none"})
        # mine stays referenced here until the row is read: the peers and
        # the store actor hold borrowed references to it meanwhile
        mine = value
        if _quant.wire_bytes(value) >= _BY_REF_BYTES:
            mine = _ByRef(ray_tpu_torch.put(value))
        deadline = time.monotonic() + timeout
        # every wait on the store is bounded by the deadline: a reply that
        # never comes fails the collective instead of hanging the rank
        ray_tpu_torch.get(self._store.put.remote(seq, self.rank, mine),
                          timeout=timeout)
        delay = 0.0005
        while True:
            row = ray_tpu_torch.get(
                self._store.gather.remote(seq),
                timeout=max(deadline - time.monotonic(), 1.0))
            if row is not None:
                refs = [v.ref for v in row if isinstance(v, _ByRef)]
                if refs:
                    vals = iter(ray_tpu_torch.get(refs, timeout=timeout))
                    row = [next(vals) if isinstance(v, _ByRef) else v
                           for v in row]
                self._store.done.remote(seq, self.rank)
                return row
            if time.monotonic() > deadline:
                # name exactly what a wedged multi-node sync needs: the
                # group, the op, the seq, and which ranks never showed
                try:
                    present = ray_tpu_torch.get(
                        self._store.present.remote(seq), timeout=5.0)
                    missing = [r for r in range(self.world_size)
                               if r not in present]
                    who = f"missing ranks {missing} of {self.world_size}"
                except Exception:
                    who = "missing-rank query failed (store unreachable?)"
                raise TimeoutError(
                    f"collective {op} on group {self.group_name!r} "
                    f"seq={seq} timed out after {timeout}s at rank "
                    f"{self.rank}: {who}")
            time.sleep(delay)
            delay = min(delay * 2, 0.05)


def _groups() -> Dict[str, CollectiveGroup]:
    return _GROUPS


def create_collective_group(world_size: int, rank: int,
                            group_name: str = "default",
                            backend: str = "object_store") -> CollectiveGroup:
    """Called by every participant (ref: collective.py:90 init_collective_group).
    backend is accepted for API parity; only object_store exists."""
    g = CollectiveGroup(group_name, world_size, rank)
    _groups()[group_name] = g
    return g


def destroy_collective_group(group_name: str = "default") -> None:
    """Tear down the local view AND the detached rendezvous store, so a
    future group with the same name starts from a clean slate (a leaked
    detached store would otherwise survive across jobs with stale slot
    rows from any timed-out collective)."""
    g = _groups().pop(group_name, None)
    if g is not None:
        try:
            ray_tpu_torch.kill(g._store)
        except Exception:
            pass
        # the kill is asynchronous: until the store is dead its name still
        # resolves, and a group re-created under the same name right away
        # (get_if_exists) would adopt the dying store and fail with
        # ActorDiedError. Wait (bounded) for the name to come free.
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                ray_tpu_torch.get_actor(g._store_name)
            except ValueError:
                break
            time.sleep(0.01)


def get_group(group_name: str = "default") -> CollectiveGroup:
    try:
        return _groups()[group_name]
    except KeyError:
        raise ValueError(
            f"Collective group {group_name!r} not initialized in this "
            "process; call create_collective_group first") from None


def _encode(tensor, codec: Optional[str]):
    """Quantize a contribution for the wire (None = pass through). A
    torch tensor is quantized as it is and decodes to a tensor."""
    if codec is None:
        return tensor
    _quant.check_codec(codec)
    return _quant.quantize(
        tensor if _quant._is_tensor(tensor) else np.asarray(tensor), codec)


def _decode_row(row: List[Any]) -> List[Any]:
    """Dequantize gathered contributions to fp32 — reductions always
    accumulate over full-precision values, never over the narrow
    payloads themselves."""
    return [_quant.dequantize(v) if isinstance(v, _quant.QuantizedTensor)
            else v for v in row]


def allreduce(tensor, group_name: str = "default", op: str = "sum",
              codec: Optional[str] = None):
    g = get_group(group_name)
    row = g._exchange(_encode(tensor, codec), op="allreduce", codec=codec)
    return _reduce(_decode_row(row), op)


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = "sum", codec: Optional[str] = None):
    g = get_group(group_name)
    row = g._exchange(_encode(tensor, codec), op="reduce", codec=codec)
    if g.rank == dst_rank:
        return _reduce(_decode_row(row), op)
    return tensor


def allgather(tensor, group_name: str = "default",
              codec: Optional[str] = None) -> List[Any]:
    g = get_group(group_name)
    row = g._exchange(_encode(tensor, codec), op="allgather", codec=codec)
    return _decode_row(row)


def reducescatter(tensor, group_name: str = "default", op: str = "sum",
                  codec: Optional[str] = None):
    g = get_group(group_name)
    row = g._exchange(_encode(tensor, codec), op="reducescatter",
                      codec=codec)
    total = _reduce(_decode_row(row), op)
    if _quant._is_tensor(total):
        # tensor_split cuts where np.array_split does: the first
        # n % world shards get one extra element
        return total.tensor_split(g.world_size)[g.rank]
    return np.array_split(np.asarray(total), g.world_size)[g.rank]


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    g = get_group(group_name)
    row = g._exchange(tensor if g.rank == src_rank else None,
                      op="broadcast")
    return row[src_rank]


def barrier(group_name: str = "default") -> None:
    get_group(group_name)._exchange(0, op="barrier")


def send(tensor, dst_rank: int, group_name: str = "default",
         tag: int = 0) -> None:
    g = get_group(group_name)
    ray_tpu_torch.get(g._store.p2p_put.remote(tag, g.rank, dst_rank, tensor))


def recv(src_rank: int, group_name: str = "default", tag: int = 0,
         timeout: float = 120.0):
    g = get_group(group_name)
    deadline = time.monotonic() + timeout
    delay = 0.0005
    while True:
        v = ray_tpu_torch.get(g._store.p2p_take.remote(tag, src_rank, g.rank))
        if not (isinstance(v, str) and v == _MISSING):
            return v
        if time.monotonic() > deadline:
            raise TimeoutError(f"recv from rank {src_rank} timed out")
        time.sleep(delay)
        delay = min(delay * 2, 0.05)
