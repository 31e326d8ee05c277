"""Compiled-graph channels: pre-allocated, single-slot, point-to-point.

The data plane of `ray_tpu_torch.cgraph` (ref: the reference's accelerated-DAG
channels — python/ray/experimental/channel/shared_memory_channel.py: a
mutable plasma object written in place per execution instead of one
immutable object per call). Two transports behind one reader/writer
contract:

- ``ShmChannel``: a pinned, never-sealed PlasmaStore segment
  (``store.allocate_channel``) shared by two processes on one host. The
  segment head is a tiny seq ledger (write_seq / read_seq / len /
  closed); the writer spins for slot vacancy (write_seq - read_seq <
  slots), writes the envelope, and publishes by bumping write_seq; the
  reader mirrors it. Slot occupancy IS the backpressure: a producer can
  run at most ``slots`` envelopes ahead of its consumer. DAG-mode
  compiled graphs use the classic single slot; the iterative pipeline
  engine (train/pipeline_cgraph.py) allocates ``slots=num_microbatches``
  rings so a whole 1F1B round's activations stream without a driver
  round trip per hop.

- ``QueueChannel``: the cross-node fallback fed by the existing worker
  RPC path — the producer ships the envelope up its node channel
  (``cgraph_send``), the head routes it to the consumer process
  (``cgraph_push``), and the consumer's loop pops it from this local
  queue. Latency is one control-plane hop; ordering is preserved by the
  per-channel monotonic seq.

Envelope: ``<II`` (flags, trace_len) + trace utf-8 + serialized body.
flags bit 0 = the body is a serialized exception (error propagation
through the graph); flags bits 8-15 carry the negotiated wire-codec id
(0 = raw, cgraph/codec.py — the body's large float arrays are
block-quantized and the READER decodes statelessly from this byte, so
mixed raw/compressed traffic shares one channel and seq/error
semantics never change); trace carries "trace_id:span_id" so per-stage
SPANs link into one cross-process flow in ``timeline()``.

Every producer-side ``send`` counts its envelope into
``ray_tpu_cgraph_channel_bytes_total{edge,codec}`` (the codec label
read from the envelope's own flag byte), so the bytes a codec saves on
a given edge are scrape-visible (docs/OBSERVABILITY.md).
"""
from __future__ import annotations

import queue as queue_mod
import struct
import threading
import time
from typing import Callable, Optional, Tuple

from ..exceptions import (ChannelFullError, CompiledGraphClosedError,
                          GetTimeoutError)
from ..perf.recorder import get_recorder
from ..util import metrics as _metrics

FLAG_ERROR = 1
# bits 8-15 of flags: wire-codec id stamped by the producer at pack
# time; 0 = raw body. The mapping is part of the envelope format so
# readers decode without per-edge negotiation state.
FLAG_CODEC_SHIFT = 8
FLAG_CODEC_MASK = 0xFF << FLAG_CODEC_SHIFT
CODEC_IDS = {"int8": 1, "e4m3": 2}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}

# fault-injection hook (ray_tpu_torch.chaos): None until chaos.enable()
# installs an engine; hot paths pay one global is-None test
_CHAOS = None

# flight recorder (perf/recorder.py): every send/recv stamps its seq
# into the process ring when enabled; one attribute test when not
_FLREC = get_recorder()

# segment layout: header then the slot payload area
_HDR = struct.Struct("<QQQQ")  # write_seq, read_seq, data_len, closed
HEADER_BYTES = 64
_ENV = struct.Struct("<II")  # flags, trace_len

_H_EDGE_WAIT = _metrics.Histogram(
    "ray_tpu_cgraph_edge_wait_seconds",
    "blocking wait for a compiled-graph channel slot (read side)",
    boundaries=_metrics.FAST_BOUNDARIES, tag_keys=("edge",))
_C_CHAN_BYTES = _metrics.Counter(
    "ray_tpu_cgraph_channel_bytes_total",
    "envelope bytes written to compiled-graph channels, by edge and "
    "the envelope's own wire-codec byte",
    tag_keys=("edge", "codec"))


def _count_send(edge: str, data: bytes) -> None:
    """Producer-side bytes accounting; codec label comes from the
    envelope's flag byte so the counter reports what actually shipped
    (a small payload under the codec floor counts as raw)."""
    try:
        flags = _ENV.unpack_from(data, 0)[0]
        codec = CODEC_NAMES.get(
            (flags & FLAG_CODEC_MASK) >> FLAG_CODEC_SHIFT, "none")
    except struct.error:
        codec = "none"
    _C_CHAN_BYTES.inc(len(data), tags={"edge": edge, "codec": codec})


def pack_envelope(flags: int, trace: str, body: bytes) -> bytes:
    t = trace.encode()
    return _ENV.pack(flags, len(t)) + t + body


def unpack_envelope(data: bytes) -> Tuple[int, str, bytes]:
    flags, tlen = _ENV.unpack_from(data, 0)
    off = _ENV.size
    trace = data[off:off + tlen].decode()
    return flags, trace, data[off + tlen:]


class _Backoff:
    """Spin-then-yield-then-sleep poll ladder. The hot window (pipelined
    steady state) resolves in the spin/yield phases; an idle resident
    loop decays to ~2 ms sleeps so parked graphs cost ~no CPU."""

    __slots__ = ("spins",)

    def __init__(self):
        self.spins = 0

    def wait(self) -> None:
        self.spins += 1
        if self.spins < 100:
            return
        if self.spins < 5000:
            time.sleep(0)  # yield the core between probes
            return
        time.sleep(min(0.002, 0.00005 * (self.spins / 5000.0)))


def segment_size(slot_bytes: int, slots: int = 1) -> int:
    """Bytes to allocate for a channel of `slots` slots each holding
    envelopes up to `slot_bytes`. Single-slot keeps the original compact
    layout (len lives in the main header); rings prepend an 8-byte len
    word to every slot."""
    if slots <= 1:
        return HEADER_BYTES + slot_bytes
    return HEADER_BYTES + slots * (8 + slot_bytes)


class ShmChannel:
    """One endpoint of a shared-memory ring channel (`slots` >= 1).

    Both endpoints attach to the same segment through a SegmentReader
    mmap; role (reader/writer) is fixed at compile time. `interrupt` is
    an optional Event polled while blocked (teardown / stop signal).
    slots=1 is the classic compiled-graph single-slot layout; slots>1
    lays the payload area out as a ring of (len, data) slots indexed by
    seq % slots — same ledger, deeper backpressure window."""

    def __init__(self, reader, name: str, size: int, edge: str = "",
                 interrupt: Optional[threading.Event] = None,
                 slots: int = 1):
        self._segreader = reader
        self._name = name
        self._size = size
        self.edge = edge
        self._interrupt = interrupt
        self._mv = reader.read(name, size)
        self._slots = max(1, int(slots))
        if self._slots == 1:
            self.capacity = size - HEADER_BYTES
        else:
            self._slot_bytes = (size - HEADER_BYTES) // self._slots
            self.capacity = self._slot_bytes - 8

    # -- ledger ----------------------------------------------------------

    def _hdr(self) -> Tuple[int, int, int, int]:
        return _HDR.unpack_from(self._mv, 0)

    def _check_alive(self) -> None:
        if self._mv is None:
            raise CompiledGraphClosedError(
                f"channel {self._name} is closed")
        closed = _HDR.unpack_from(self._mv, 0)[3]
        if closed:
            raise CompiledGraphClosedError(
                f"channel {self._name} was closed by its peer")
        if self._interrupt is not None and self._interrupt.is_set():
            raise CompiledGraphClosedError(
                f"channel {self._name}: graph stopping")

    def mark_closed(self) -> None:
        """Poison the ledger so the peer's next poll raises (teardown /
        fault fencing); safe to call from either endpoint."""
        if self._mv is not None:
            try:
                struct.pack_into("<Q", self._mv, 24, 1)
            except ValueError:
                pass  # segment already unmapped

    # -- writer ----------------------------------------------------------

    def send(self, data: bytes, timeout: Optional[float] = None) -> None:
        if _CHAOS is not None and _CHAOS.channel_poison(self.edge):
            self.mark_closed()  # _check_alive below raises for both ends
        if len(data) > self.capacity:
            raise ChannelFullError(
                f"payload of {len(data)} bytes exceeds channel capacity "
                f"{self.capacity} (raise channel_bytes at compile time)")
        deadline = None if timeout is None else time.monotonic() + timeout
        bo = _Backoff()
        blocked = False
        while True:
            self._check_alive()
            w, r, _, _ = self._hdr()
            if w - r < self._slots:  # a slot is vacant
                break
            if not blocked:
                # a send stuck on a dead/stalled consumer leaves this
                # begin dangling — the post-mortem in-flight marker
                blocked = True
                if _FLREC.enabled:
                    _FLREC.record("chan.send.begin",
                                  self.edge or self._name, {"seq": w})
            if deadline is not None and time.monotonic() > deadline:
                raise GetTimeoutError(
                    f"channel {self.edge or self._name}: send timed out "
                    f"(all {self._slots} slots occupied — consumer "
                    f"stalled)")
            bo.wait()
        if self._slots == 1:
            self._mv[HEADER_BYTES:HEADER_BYTES + len(data)] = data
            struct.pack_into("<Q", self._mv, 16, len(data))
        else:
            # _slot_bytes INCLUDES the slot's 8-byte len word — it is
            # the stride, not the payload capacity (capacity above)
            off = HEADER_BYTES + (w % self._slots) * self._slot_bytes
            struct.pack_into("<Q", self._mv, off, len(data))
            self._mv[off + 8:off + 8 + len(data)] = data
        struct.pack_into("<Q", self._mv, 0, w + 1)  # publish
        _count_send(self.edge or self._name, data)
        if _FLREC.enabled:
            if blocked:
                _FLREC.record("chan.send.end", self.edge or self._name,
                              {"seq": w})
            _FLREC.record("chan.send", self.edge or self._name,
                          {"seq": w})

    # -- reader ----------------------------------------------------------

    def recv(self, timeout: Optional[float] = None) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        bo = _Backoff()
        t0 = time.perf_counter()
        while True:
            self._check_alive()
            w, r, n, _ = self._hdr()
            if w > r:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise GetTimeoutError(
                    f"channel {self.edge or self._name}: recv timed out")
            bo.wait()
        waited = time.perf_counter() - t0
        if waited > 1e-5:
            _H_EDGE_WAIT.observe(waited, tags={"edge": self.edge})
        # copy out BEFORE releasing the slot: the deserialized value may
        # alias these bytes zero-copy, and the producer overwrites the
        # slot the moment read_seq advances
        if self._slots == 1:
            data = bytes(self._mv[HEADER_BYTES:HEADER_BYTES + n])
        else:
            off = HEADER_BYTES + (r % self._slots) * self._slot_bytes
            n = struct.unpack_from("<Q", self._mv, off)[0]
            data = bytes(self._mv[off + 8:off + 8 + n])
        struct.pack_into("<Q", self._mv, 8, r + 1)  # release the slot
        if _FLREC.enabled:
            _FLREC.record("chan.recv", self.edge or self._name,
                          {"seq": r})
        return data

    def close(self) -> None:
        self.mark_closed()
        mv = self._mv
        self._mv = None
        if mv is not None:
            del mv
            try:
                self._segreader.release(self._name)
            except Exception:
                pass

    def detach(self) -> None:
        """Release this endpoint's mapping WITHOUT poisoning the
        ledger: the peer — and any successor endpoint attaching to the
        same segment — keeps running. This is the writer-role handoff
        primitive (the seq ledger is segment-resident, so a new writer
        resumes exactly where this one left off); the data feed's
        detach path uses it to hand the input rings back to the
        driver."""
        mv = self._mv
        self._mv = None
        if mv is not None:
            del mv
            try:
                self._segreader.release(self._name)
            except Exception:
                pass


class QueueChannel:
    """Consumer endpoint of a cross-node edge: a local queue fed by
    ``cgraph_push`` deliveries relayed through the head. Relay hops run
    on RPC handler POOLS (worker -> agent -> head -> consumer), so two
    back-to-back envelopes can arrive reordered when the pipeline engine
    streams a whole microbatch round down one edge; ``deliver`` holds
    early arrivals in a reorder buffer and releases them to the consumer
    strictly in seq order. (DAG-mode graphs never have two envelopes in
    flight per edge, so the buffer stays empty there.)"""

    def __init__(self, cid: str, edge: str = "",
                 interrupt: Optional[threading.Event] = None):
        self.cid = cid
        self.edge = edge
        self._interrupt = interrupt
        self._q: "queue_mod.Queue" = queue_mod.Queue()
        self._next_seq = 0
        self._closed = threading.Event()
        self._dlock = threading.Lock()
        self._deliver_seq = 0
        self._pending: dict = {}

    def deliver(self, seq: int, data: bytes) -> None:
        with self._dlock:
            self._pending[seq] = data
            while self._deliver_seq in self._pending:
                self._q.put((self._deliver_seq,
                             self._pending.pop(self._deliver_seq)))
                self._deliver_seq += 1

    def recv(self, timeout: Optional[float] = None) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.perf_counter()
        while True:
            if self._closed.is_set() or (
                    self._interrupt is not None
                    and self._interrupt.is_set()):
                raise CompiledGraphClosedError(
                    f"channel {self.edge or self.cid}: graph stopping")
            try:
                seq, data = self._q.get(timeout=0.05)
            except queue_mod.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    raise GetTimeoutError(
                        f"channel {self.edge or self.cid}: recv timed out")
                continue
            if data is None:  # close sentinel
                raise CompiledGraphClosedError(
                    f"channel {self.edge or self.cid} closed")
            if seq != self._next_seq:
                raise CompiledGraphClosedError(
                    f"channel {self.edge or self.cid}: out-of-order "
                    f"delivery (seq {seq}, expected {self._next_seq})")
            self._next_seq += 1
            waited = time.perf_counter() - t0
            if waited > 1e-5:
                _H_EDGE_WAIT.observe(waited, tags={"edge": self.edge})
            if _FLREC.enabled:
                _FLREC.record("chan.recv", self.edge or self.cid,
                              {"seq": seq})
            return data

    def close(self) -> None:
        self._closed.set()
        self._q.put((0, None))

    def mark_closed(self) -> None:
        self.close()


class RpcSender:
    """Producer endpoint of a cross-node edge: ships each envelope up the
    process's control channel (`send_fn`); the head routes it to the
    consumer. Seq stamps preserve the single-slot FIFO contract."""

    def __init__(self, send_fn: Callable[[str, int, bytes], None],
                 cid: str, edge: str = ""):
        self._send_fn = send_fn
        self.cid = cid
        self.edge = edge
        self._seq = 0

    def send(self, data: bytes, timeout: Optional[float] = None) -> None:
        seq = self._seq
        self._seq += 1
        self._send_fn(self.cid, seq, data)
        _count_send(self.edge or self.cid, data)
        if _FLREC.enabled:
            _FLREC.record("chan.send", self.edge or self.cid,
                          {"seq": seq})

    def close(self) -> None:
        pass

    def mark_closed(self) -> None:
        pass
