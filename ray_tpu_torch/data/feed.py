"""DataFeed — the terminal stage of the data plane: prefetch actors
that pump (inputs, targets) microbatches straight into a
CompiledPipelineEngine's input rings.

The driver-fed pipeline engine sends every microbatch down the
``r{r}:in->c0`` / ``r{r}:in->targets`` cgraph channels from ``step()``.
``engine.attach_feed(feed)`` moves that producer role OUT of the driver:
one ``_FeedPump`` actor per dp replica pulls block refs from its shard,
packs fixed-shape ``(inputs, targets)`` microbatches, and writes the
SAME envelopes into the SAME pre-allocated rings — ``engine.step()``
with no batch then only *reads* losses/reports, so the steady-state
train loop runs with zero driver round-trips (asserted against
``runtime.dispatch_counts()``).

Why this composes instead of being a second system:

- **Channels**: a ShmChannel's seq ledger lives in the shared segment,
  not in the endpoint, so the writer role hands off between processes
  by just opening the segment; cross-node rpc edges hand off by passing
  the current seq. No new channel kinds, no reallocation.
- **Backpressure**: ring slot occupancy IS the admit signal — a pump
  blocks in ``send`` once it runs ``slots`` (= num_microbatches)
  envelopes ahead of the consuming stage, exactly like the byte-budget
  admits upstream (executor.py _ByteWindow) throttle the segment above.
- **Faults**: pump actors are a stateless tier. Death aborts the engine
  with a typed :class:`ray_tpu_torch.exceptions.DataFeedError`;
  ``engine.recover()`` respawns stages, recompiles channels, and
  re-attaches the feed from its factories. Preemption drains them like
  any stateless pool.

Counterpart of ray_tpu/data/feed.py. A pump writes what the port's
hand-fed ``step()`` writes for the same value: the envelope of the
value's serialization with every torch tensor moved to the host first
(``_host_value``), so numpy arrays and CPU tensors cross unchanged and a
fed trajectory is bit for bit a hand-fed one. A pump that never meets a
tensor never imports torch.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence

from .._vendor import cloudpickle

from ..util import metrics as _metrics

_C_FEED_MB = _metrics.Counter(
    "ray_tpu_data_feed_microbatches_total",
    "(inputs, targets) microbatch pairs pushed into pipeline-engine "
    "input rings by data-feed pump actors")


class DataFeed:
    """Driver-side descriptor of a dp-sharded feed.

    ``factories`` is one zero-arg callable per dp replica; each runs
    INSIDE that replica's pump actor and must return an iterator of
    ``(inputs, targets)`` microbatch pairs (the exact values ``step()``
    would have been hand-fed, in the same order — the engine's loss
    trajectory is then bit-identical to hand-feeding). The callables are
    cloudpickled at construction, so captured DataShard block refs
    travel to the pump actors and are pulled there, not on the driver.
    """

    def __init__(self, factories: Sequence[Callable[[], Any]], *,
                 name: str = "feed"):
        if not factories:
            raise ValueError("DataFeed needs at least one shard factory")
        self.name = str(name)
        self.shard_blobs: List[bytes] = [cloudpickle.dumps(f)
                                         for f in factories]
        # the blobs are opaque bytes: the block refs a factory captures
        # (a DataShard's) are counted only while the factory itself is
        # alive, so the feed keeps it — otherwise the owner frees the
        # blocks as soon as the caller drops its shards, and a pump's get
        # waits for them forever (ROADMAP C)
        self._factories = list(factories)

    @property
    def dp(self) -> int:
        return len(self.shard_blobs)

    @classmethod
    def from_shards(cls, shards: Sequence[Any],
                    to_microbatches: Callable[[Any], Any], *,
                    name: str = "feed") -> "DataFeed":
        """Build a feed over ``Dataset.split_shards(dp)`` output:
        ``to_microbatches(shard)`` runs inside the pump actor and
        returns the shard's ``(inputs, targets)`` iterator (typically a
        generator over ``shard.iter_batches(...)``)."""
        return cls([(lambda s=s: to_microbatches(s)) for s in shards],
                   name=name)


def _host_value(v: Any) -> Any:
    """``v`` with every torch tensor inside it (through dicts, lists and
    tuples) detached onto the CPU — what the engine's ``step()`` does to
    a hand-fed value before serializing it."""
    if isinstance(v, dict):
        return {k: _host_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_host_value(x) for x in v)
    if type(v).__module__.startswith("torch") and hasattr(v, "detach"):
        return v.detach().cpu()
    return v


def _make_writer(spec: dict, graph_id: bytes, start_seq: int,
                 interrupt: threading.Event):
    """Writer endpoint onto an engine input edge, from inside a pump
    actor. shm: attach to the ring segment (the seq ledger is
    segment-resident, so the handoff from the driver's endpoint is
    free — this requires running on the segment's node, which
    attach_feed guarantees by placement). rpc: ship envelopes up this
    worker's control channel; the head routes them to the consuming
    stage exactly as driver sends were, continuing at ``start_seq``."""
    from ..cgraph.channel import RpcSender, ShmChannel
    from ..core import runtime as _rt
    from ..core.object_store import SegmentReader

    if spec["kind"] == "shm":
        return ShmChannel(SegmentReader(), spec["name"], spec["size"],
                          edge=spec.get("edge", ""), interrupt=interrupt,
                          slots=spec.get("slots", 1))
    rt = _rt.get_runtime()
    channel = rt.channel

    def send(cid, seq, data):
        channel.call("cgraph_send", {"graph_id": graph_id, "cid": cid,
                                     "seq": seq, "data": data},
                     timeout=120)

    sender = RpcSender(send, spec["cid"], edge=spec.get("edge", ""))
    sender._seq = int(start_seq)
    return sender


class _FeedPump:
    """One dp replica's prefetch/pump actor (spawned by
    ``CompiledPipelineEngine.attach_feed``). A resident thread drains
    the shard iterator into the input rings; ring slot occupancy
    backpressures it, channel poisoning (engine teardown/abort) stops
    it."""

    def setup(self, in_spec: dict, tgt_spec: dict, in_seq: int,
              tgt_seq: int, graph_id: bytes, factory_blob: bytes,
              tag: str) -> bool:
        self._stopev = threading.Event()
        self._in_w = _make_writer(in_spec, graph_id, in_seq, self._stopev)
        self._tgt_w = _make_writer(tgt_spec, graph_id, tgt_seq,
                                   self._stopev)
        self._factory = cloudpickle.loads(factory_blob)
        self._tag = str(tag)
        self._sent = 0
        self._exhausted = False
        self._error: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        return True

    def start(self) -> bool:
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"data-feed-{self._tag}")
        self._thread.start()
        return True

    def _run(self) -> None:
        from ..cgraph.channel import pack_envelope
        from ..core import serialization
        from ..exceptions import CompiledGraphClosedError

        try:
            for x, tgt in self._factory():
                if self._stopev.is_set():
                    return
                # same envelope bytes the driver's hand-fed step()
                # writes — the stage actors cannot tell the difference,
                # so the loss trajectory is bit-identical
                env_x = pack_envelope(
                    0, "", serialization.dumps(_host_value(x)))
                env_t = pack_envelope(
                    0, "", serialization.dumps(_host_value(tgt)))
                # blocks here once `slots` envelopes ahead of the
                # consuming stage: slot occupancy is the admit signal
                self._in_w.send(env_x)
                self._tgt_w.send(env_t)
                self._sent += 1
                _C_FEED_MB.inc()
            self._exhausted = True
        except CompiledGraphClosedError:
            pass  # engine teardown/abort poisoned the ring: clean stop
        except BaseException as e:  # noqa: BLE001 — surfaced via stats()
            self._error = repr(e)

    def stats(self) -> dict:
        return {"sent": self._sent,
                "exhausted": self._exhausted,
                "error": self._error,
                "in_seq": getattr(self._in_w, "_seq", None),
                "tgt_seq": getattr(self._tgt_w, "_seq", None)}

    def stop(self) -> dict:
        """Stop the pump and release the endpoints; returns final stats
        (the engine resyncs rpc writer seqs from in_seq/tgt_seq when
        hand-feeding resumes after detach)."""
        self._stopev.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        st = self.stats()
        for ch in (self._in_w, self._tgt_w):
            try:
                # detach, never close: closing poisons the ring ledger
                # and would kill the engine this pump is handing the
                # writer role back to
                if hasattr(ch, "detach"):
                    ch.detach()
                else:
                    ch.close()
            except Exception:
                pass
        return st
