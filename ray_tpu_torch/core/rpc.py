"""Bidirectional RPC channel over ``multiprocessing.connection``.

Equivalent of the reference's rpc layer (ref: src/ray/rpc/grpc_server.h,
client_call.h — callback-based client calls multiplexed on a shared channel).
Here: one duplex byte pipe (Unix socket or TCP) per peer pair. The same
protocol runs over AF_UNIX within a host and AF_INET across hosts (DCN
control plane).

Threading model (the per-peer thread-pool era ended with the round-5
219-thread flake): a process owns ONE reader hub thread multiplexing every
channel's receive side via ``multiprocessing.connection.wait``, plus one
shared elastic worker pool (threads spawn on demand and exit after an idle
timeout). Each channel contributes zero dedicated threads — its request
handlers, oneway lane, and writer are FIFO *lanes* drained on the shared
pool, so process thread count tracks concurrent load, not peer count.
"""
from __future__ import annotations

import itertools
import os
import socket
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future
from multiprocessing.connection import Client, Connection, Listener
from multiprocessing.connection import wait as _mpc_wait
from typing import Any, Callable, Dict, Optional

_REQ, _RESP, _ERR, _ONEWAY = 0, 1, 2, 3
# a coalesced frame: payload is a list of already-encoded frames. Under
# burst (task pushes, done floods, direct submits/results) the writer
# lane drains its queue into one send and the reader dispatches the
# whole batch with one wakeup — syscalls and thread hops amortize
# across the batch
_BATCH = 4
_BATCH_MAX = 64

# per-handler instrumentation (ref: the reference's per-RPC gRPC stats,
# src/ray/stats/metric_defs.cc grpc_server_req_* counters): method ->
# [calls, errors, total_seconds] backing rpc_stats(), plus a bucketed
# latency histogram per method in the shared metrics registry — in
# worker/agent processes the histogram ships to the head's /metrics
# with node/worker tags (util/metrics.py snapshot_deltas).
from ..util import metrics as _metrics

_RPC_STATS: Dict[str, list] = {}
_RPC_STATS_LOCK = threading.Lock()

# fault-injection hook (ray_tpu_torch.chaos): None until chaos.enable()
# installs an engine — the frame paths pay one global is-None test when
# disabled, and this module never imports the chaos package
_CHAOS = None
_RPC_LATENCY = _metrics.Histogram(
    "ray_tpu_rpc_handler_seconds",
    "per-RPC-method handler latency (request and oneway frames)",
    boundaries=_metrics.FAST_BOUNDARIES, tag_keys=("method",))
_RPC_ERRORS = _metrics.Counter(
    "ray_tpu_rpc_errors_total", "per-RPC-method handler errors",
    tag_keys=("method",))


def _record_rpc(method: str, seconds: float, error: bool) -> None:
    with _RPC_STATS_LOCK:
        row = _RPC_STATS.get(method)
        if row is None:
            row = _RPC_STATS[method] = [0, 0, 0.0]
        row[0] += 1
        if error:
            row[1] += 1
        row[2] += seconds
    _RPC_LATENCY.observe(seconds, tags={"method": method})
    if error:
        _RPC_ERRORS.inc(tags={"method": method})


def rpc_stats() -> Dict[str, dict]:
    """{method: {calls, errors, total_s, avg_ms}} for every RPC method
    this process has served."""
    with _RPC_STATS_LOCK:
        return {m: {"calls": c, "errors": e, "total_s": round(t, 4),
                    "avg_ms": round(t / c * 1e3, 3) if c else 0.0}
                for m, (c, e, t) in _RPC_STATS.items()}


class ChannelClosed(Exception):
    pass


class ElasticPool:
    """Shared worker pool whose thread count tracks CONCURRENT load.

    Unlike ThreadPoolExecutor (which holds every thread it ever spawned),
    threads exit after ``idle_s`` without work, and a new thread spawns
    only when a task arrives with no idle thread to take it. A blocked
    handler therefore costs one thread for exactly as long as it blocks,
    and a process serving 50 peers sequentially runs on ~1 thread.
    The max_threads cap is a runaway backstop, far above real load."""

    def __init__(self, name: str = "rpc", idle_s: float = 8.0,
                 max_threads: int = 512):
        self._name = name
        self._idle_s = idle_s
        self._max = max_threads
        self._cv = threading.Condition()
        self._q: deque = deque()
        self._threads = 0
        self._waiting = 0
        self._seq = itertools.count()

    def submit(self, fn: Callable, *args) -> None:
        spawn = False
        with self._cv:
            self._q.append((fn, args))
            if self._waiting:
                self._cv.notify()
            # spawn whenever queue depth exceeds the waiter count, not
            # only when no waiter exists: a waiter that was ALREADY
            # notified (but hasn't reacquired the lock, so _waiting still
            # counts it) can absorb only one item — counting it for a
            # second submit would lose that wakeup, stranding the item
            # until an unrelated submit (deadlock if the running handler
            # blocks on the stranded one, e.g. a fetch whose seal
            # notification sits behind it). A spare thread idles out.
            if len(self._q) > self._waiting and self._threads < self._max:
                self._threads += 1
                spawn = True
        if spawn:
            threading.Thread(
                target=self._run, daemon=True,
                name=f"{self._name}-{next(self._seq)}").start()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q:
                    self._waiting += 1
                    self._cv.wait(self._idle_s)
                    self._waiting -= 1
                    if not self._q:
                        # idle timeout (or spurious wake with nothing to
                        # do): retire — submit() spawns a fresh thread
                        # when load returns
                        self._threads -= 1
                        return
                fn, args = self._q.popleft()
            try:
                fn(*args)
            except Exception:
                traceback.print_exc()

    def stats(self) -> dict:
        with self._cv:
            return {"threads": self._threads, "waiting": self._waiting,
                    "queued": len(self._q)}


_POOL_LOCK = threading.Lock()
_POOL: Optional[ElasticPool] = None


def shared_pool() -> ElasticPool:
    """The process-wide RPC worker pool (handlers, oneway lanes, writers)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ElasticPool("rpcw")
        return _POOL


class _Lane:
    """FIFO work lane with bounded concurrency, drained on the shared pool.

    Items keep arrival order; at most ``max_active`` drainers run at once
    (1 = strict FIFO processing — the oneway and writer lanes; N = the
    request lane's per-channel handler concurrency). No dedicated thread:
    a drainer claims a pool thread only while items exist."""

    __slots__ = ("_pool", "_fn", "_q", "_lock", "_active", "_max")

    def __init__(self, pool: ElasticPool, fn: Callable[[Any], None],
                 max_active: int = 1):
        self._pool = pool
        self._fn = fn
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._active = 0
        self._max = max(1, int(max_active))

    def push(self, item) -> None:
        with self._lock:
            self._q.append(item)
            if self._active >= self._max:
                return
            self._active += 1
        self._pool.submit(self._drain)

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._q:
                    self._active -= 1
                    return
                item = self._q.popleft()
            try:
                self._fn(item)
            except Exception:
                traceback.print_exc()

    def idle(self) -> bool:
        with self._lock:
            return not self._q and self._active == 0


class _ReaderHub:
    """One thread multiplexing every channel's receive side.

    ``multiprocessing.connection.wait`` over all registered connections;
    ready frames are decoded and dispatched to the owning channel's lanes
    (which run on the shared pool), so the hub never blocks on a handler.
    Only the hub closes a registered connection — deregistration is
    requested via flag + wakeup, which keeps the fd out of the selector
    before it goes invalid."""

    def __init__(self):
        self._lock = threading.Lock()
        self._channels: Dict[int, "RpcChannel"] = {}  # conn fileno -> ch
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._started = False

    def _ensure_thread(self) -> None:
        if not self._started:
            self._started = True
            threading.Thread(target=self._loop, daemon=True,
                             name="rpc-hub").start()

    def register(self, ch: "RpcChannel") -> None:
        with self._lock:
            self._channels[ch._conn.fileno()] = ch
            self._ensure_thread()
        self.wake()

    def request_drop(self, ch: "RpcChannel") -> None:
        """Ask the hub to stop watching + close the channel's conn."""
        ch._drop_requested = True
        self.wake()

    def wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except Exception:
            pass

    def _loop(self) -> None:
        while True:
            with self._lock:
                dead = [ch for ch in self._channels.values()
                        if ch._drop_requested]
                for ch in dead:
                    self._channels.pop(ch._conn.fileno(), None)
                conns = {ch._conn: ch for ch in self._channels.values()}
            for ch in dead:
                try:
                    ch._conn.close()
                except Exception:
                    pass
            try:
                ready = _mpc_wait([*conns.keys(), self._wake_r])
            except Exception:
                # a conn went bad between snapshot and wait (peer died
                # mid-registration): probe each individually and drop
                # the broken ones
                for conn, ch in conns.items():
                    try:
                        conn.poll(0)
                    except Exception:
                        self._drop_broken(ch)
                continue
            for obj in ready:
                if obj is self._wake_r:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except BlockingIOError:
                        pass
                    except Exception:
                        pass
                    continue
                ch = conns.get(obj)
                if ch is None or ch._drop_requested:
                    continue
                try:
                    data = obj.recv_bytes()
                except Exception:
                    # EOF / reset / torn down: this channel only
                    self._drop_broken(ch)
                    continue
                try:
                    ch._on_bytes(data)
                except Exception:
                    traceback.print_exc()

    def _drop_broken(self, ch: "RpcChannel") -> None:
        with self._lock:
            self._channels.pop(ch._conn.fileno(), None)
        try:
            ch._conn.close()
        except Exception:
            pass
        # teardown callbacks (worker-exit handling etc.) can be heavy:
        # run them on the pool, never on the hub thread
        shared_pool().submit(ch._teardown)


_HUB_LOCK = threading.Lock()
_HUB: Optional[_ReaderHub] = None


def reader_hub() -> _ReaderHub:
    global _HUB
    with _HUB_LOCK:
        if _HUB is None:
            _HUB = _ReaderHub()
        return _HUB


class RpcChannel:
    """A duplex message channel with request/response correlation.

    handler(method: str, payload: Any) -> Any  serves incoming requests.
    """

    def __init__(self, conn: Connection,
                 handler: Optional[Callable[[str, Any], Any]] = None,
                 num_handler_threads: Optional[int] = None,
                 name: str = "",
                 autostart: bool = True):
        if num_handler_threads is None:
            from .config import DEFAULT

            num_handler_threads = int(DEFAULT.rpc_handler_threads)
        self._conn = conn
        self._handler = handler
        self._name = name
        self._seq = itertools.count()
        self._pending: Dict[int, Future] = {}
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._started = False
        self._drop_requested = False
        self._on_close_cbs = []
        pool = shared_pool()
        # request handlers: per-channel concurrency cap (the old
        # per-channel ThreadPoolExecutor's max_workers), shared threads
        self._req_lane = _Lane(pool, self._handle_req,
                               max_active=num_handler_threads)
        # Notifications get their own single-drainer lane: they stay FIFO
        # and can never be starved by blocking request handlers (e.g. a
        # fetch waiting on an object whose seal NOTIFICATION would satisfy
        # it — the reference keeps these planes separate too: pubsub
        # long-poll vs request RPCs).
        self._ow_lane = _Lane(pool, self._handle_oneway_item, max_active=1)
        # Single-drainer writer lane owns conn.send. Senders only enqueue,
        # so a full socket buffer can never block the hub, a handler, or a
        # GC finalizer (an ObjectRef finalizer notifying remove_ref from
        # inside the reader's loop deadlocked both pipe directions before
        # this). The drain coalesces queued frames into _BATCH sends.
        self._outbox: deque = deque()
        self._out_lock = threading.Lock()
        self._out_active = False
        self._out_idle = threading.Condition(self._out_lock)
        if autostart:
            self.start()

    def start(self) -> None:
        """Begin reading. Callers that must install a handler first pass
        autostart=False — otherwise a message can race the handler install."""
        if not self._started:
            self._started = True
            reader_hub().register(self)

    # -- client side -----------------------------------------------------------

    def call(self, method: str, payload: Any = None, timeout: Optional[float] = None) -> Any:
        return self.call_async(method, payload).result(timeout)

    def call_async(self, method: str, payload: Any = None) -> Future:
        fut: Future = Future()
        msg_id = next(self._seq)
        with self._lock:
            if self._closed.is_set():
                fut.set_exception(ChannelClosed(f"channel {self._name} closed"))
                return fut
            self._pending[msg_id] = fut
        try:
            self._send((_REQ, msg_id, method, payload))
        except Exception as e:
            with self._lock:
                self._pending.pop(msg_id, None)
            if not fut.done():  # teardown may have failed it already
                fut.set_exception(ChannelClosed(str(e)))
        return fut

    def notify(self, method: str, payload: Any = None) -> None:
        """Fire-and-forget."""
        try:
            self._send((_ONEWAY, 0, method, payload))
        except Exception:
            pass

    def _send(self, msg) -> None:
        if self._closed.is_set():
            raise ChannelClosed(f"channel {self._name} closed")
        with self._out_lock:
            self._outbox.append(msg)
            if self._out_active:
                return
            self._out_active = True
        shared_pool().submit(self._write_drain)

    def _write_drain(self) -> None:
        from . import wire

        while True:
            with self._out_lock:
                if not self._outbox:
                    self._out_active = False
                    self._out_idle.notify_all()
                    return
                # drain up to a batch's worth under the lock; encoding
                # and the send syscall happen outside it
                msgs = [self._outbox.popleft()
                        for _ in range(min(len(self._outbox), _BATCH_MAX))]
            if _CHAOS is not None:
                # seeded drop/delay/duplicate/reorder of outbound frames
                # (oneway only for drop/dup — see ray_tpu_torch.chaos docs)
                msgs = _CHAOS.rpc_send(msgs)
                if not msgs:
                    continue
            frames = []
            for msg in msgs:
                try:
                    # typed frames, never pickle: see wire.py (the
                    # reference's control plane is protobuf/gRPC; pickle
                    # framing here was an RCE amplifier behind one token)
                    frames.append(wire.encode(msg))
                except wire.WireEncodeError:
                    traceback.print_exc()
                    self._fail_encode(msg)
                except Exception:
                    self._teardown()
                    with self._out_lock:
                        self._out_active = False
                        self._out_idle.notify_all()
                    return
            if not frames:
                continue
            try:
                if len(frames) == 1:
                    self._conn.send_bytes(frames[0])
                else:
                    self._conn.send_bytes(
                        wire.encode((_BATCH, 0, None, frames)))
            except Exception:
                self._teardown()
                with self._out_lock:
                    self._out_active = False
                    self._out_idle.notify_all()
                return

    def _flush_writer(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        with self._out_lock:
            while self._outbox or self._out_active:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._out_idle.wait(remaining)

    def _fail_encode(self, msg) -> None:
        """One bad payload must not kill the channel — but it must not
        strand its correlated future either: fail a _REQ's future
        locally; answer a _RESP's caller with an _ERR."""
        from . import wire

        kind, msg_id = msg[0], msg[1]
        if kind == _REQ:
            with self._lock:
                fut = self._pending.pop(msg_id, None)
            if fut is not None and not fut.done():
                fut.set_exception(wire.WireEncodeError(
                    f"payload for {msg[2]!r} not wire-encodable"))
        elif kind == _RESP:
            try:
                self._conn.send_bytes(wire.encode(
                    (_ERR, msg_id, "WireEncodeError: unencodable response",
                     "")))
            except Exception:
                pass

    # -- server side -----------------------------------------------------------

    def set_handler(self, handler: Callable[[str, Any], Any]) -> None:
        self._handler = handler

    def _on_bytes(self, data: bytes) -> None:
        """Hub delivery of one raw frame: decode + route to lanes. Runs on
        the hub thread — must never block on a handler."""
        from . import wire

        try:
            msg = wire.decode(data)
            kind, msg_id, a, b = msg
            if not isinstance(kind, int) or not isinstance(msg_id, int):
                raise wire.WireDecodeError("bad frame header")
        except (wire.WireDecodeError, ValueError, TypeError):
            # malformed/malicious frame: it was never evaluated — drop it
            # and keep serving (a pickle-framing channel would have
            # executed it on recv)
            traceback.print_exc()
            return
        if kind == _BATCH:
            self._dispatch_batch(b)
        else:
            self._dispatch_frame(kind, msg_id, a, b)

    def _dispatch_batch(self, frames) -> None:
        from . import wire

        if not isinstance(frames, (list, tuple)):
            return  # malformed batch body: drop
        for data in frames:
            try:
                kind, msg_id, a, b = wire.decode(data)
                if not isinstance(kind, int) or not isinstance(msg_id, int):
                    raise wire.WireDecodeError("bad frame header")
            except (wire.WireDecodeError, ValueError, TypeError):
                traceback.print_exc()
                continue
            if kind == _BATCH:
                continue  # no nesting
            self._dispatch_frame(kind, msg_id, a, b)

    def _dispatch_frame(self, kind: int, msg_id: int, a, b) -> None:
        if kind == _RESP:
            with self._lock:
                fut = self._pending.pop(msg_id, None)
            if fut is not None:
                fut.set_result(b)
        elif kind == _ERR:
            with self._lock:
                fut = self._pending.pop(msg_id, None)
            if fut is not None:
                fut.set_exception(_RemoteCallError(a, b))
        elif kind == _REQ:
            self._req_lane.push((msg_id, a, b))
        elif kind == _ONEWAY:
            if _CHAOS is not None and _CHAOS.recv_drop(a):
                return  # injected receiver-side loss
            self._ow_lane.push((a, b))

    def _handle_req(self, item) -> None:
        msg_id, method, payload = item
        t0 = time.perf_counter()
        ok = False
        try:
            result = self._handler(method, payload)
            self._send((_RESP, msg_id, None, result))
            ok = True  # only after the reply went out: a failed _RESP
            # send IS a client-visible error and must count as one
        except Exception as e:
            try:
                self._send((_ERR, msg_id, f"{type(e).__name__}: {e}",
                            traceback.format_exc()))
            except Exception:
                pass
        finally:
            _record_rpc(method, time.perf_counter() - t0, not ok)

    def _handle_oneway_item(self, item) -> None:
        method, payload = item
        t0 = time.perf_counter()
        ok = False
        try:
            self._handler(method, payload)
            ok = True
        except Exception:
            traceback.print_exc()
        finally:
            _record_rpc(method, time.perf_counter() - t0, not ok)

    # -- lifecycle -------------------------------------------------------------

    def on_close(self, cb: Callable[[], None]) -> None:
        with self._lock:
            if not self._closed.is_set():
                self._on_close_cbs.append(cb)
                return
        # teardown already ran: fire immediately so late registrants (e.g.
        # a node handle built while the peer was dying) still observe the
        # death
        try:
            cb()
        except Exception:
            traceback.print_exc()

    def _teardown(self) -> None:
        with self._lock:
            if self._closed.is_set():
                return
            self._closed.set()
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(ChannelClosed(f"channel {self._name} closed"))
        for cb in self._on_close_cbs:
            try:
                cb()
            except Exception:
                traceback.print_exc()

    def close(self) -> None:
        self._teardown()
        # give the writer lane a moment to flush already-queued messages
        # (e.g. a final "shutdown" notify) before the connection drops
        self._flush_writer(2.0)
        if self._started:
            # a registered conn is only closed by the hub, so the fd never
            # goes invalid inside the selector
            reader_hub().request_drop(self)
        else:
            try:
                self._conn.close()
            except Exception:
                pass

    @property
    def closed(self) -> bool:
        return self._closed.is_set()


class _RemoteCallError(Exception):
    def __init__(self, summary: str, remote_tb: str):
        super().__init__(f"{summary}\n--- remote traceback ---\n{remote_tb}")
        self.summary = summary
        self.remote_tb = remote_tb

    def __reduce__(self):
        # default Exception reduction replays args=(message,) into the
        # 2-arg __init__ and fails on unpickle — these DO cross process
        # boundaries when a task result carries one
        return (_RemoteCallError, (self.summary, self.remote_tb))


_CLUSTER_TOKEN: Optional[bytes] = None


def cluster_token() -> bytes:
    """Per-cluster RPC auth token.

    multiprocessing.connection unpickles peer payloads, so a guessable
    authkey means anyone who can reach the head port gets code execution
    on every node (the reference's cross-host plane is gRPC/protobuf and
    has no such amplification). The token is generated fresh per head
    process, inherited by worker/agent subprocesses through the
    RTPU_AUTHKEY env var, and handed to remote machines via the join
    command `ray_tpu_torch start --head` prints. The port must still only be
    exposed on a trusted network — the token authenticates, it does not
    encrypt."""
    global _CLUSTER_TOKEN
    if _CLUSTER_TOKEN is None:
        env = os.environ.get("RTPU_AUTHKEY", "")
        if env:
            _CLUSTER_TOKEN = bytes.fromhex(env)
        else:
            import secrets

            _CLUSTER_TOKEN = secrets.token_bytes(32)
            # exported so child processes (workers, agents started from
            # this process) authenticate without the key appearing in argv
            os.environ["RTPU_AUTHKEY"] = _CLUSTER_TOKEN.hex()
    return _CLUSTER_TOKEN


class RpcServer:
    """Accepts channel connections on a Unix or TCP socket."""

    def __init__(self, address, handler_factory: Callable[[RpcChannel], Callable],
                 family: Optional[str] = None, authkey: Optional[bytes] = None,
                 num_handler_threads: int = 16):
        # backlog: the multiprocessing default of 1 refuses concurrent
        # connects (peer direct-call channels + multi-driver bursts all
        # land at once); a refused connect reads as "unreachable" and
        # would push callers onto the routed path
        self._listener = Listener(address, family=family, backlog=64,
                                  authkey=authkey or cluster_token())
        self._handler_factory = handler_factory
        self._num_handler_threads = num_handler_threads
        self._channels = []
        self._stopped = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True,
                                               name="rpc-accept")
        self._accept_thread.start()

    @property
    def address(self):
        return self._listener.address

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn = self._listener.accept()
            except Exception:
                # A peer dying mid-handshake raises here; keep accepting —
                # only a closed listener ends the loop.
                if self._stopped.is_set():
                    break
                try:
                    # closed listener raises immediately again; back off a hair
                    import time as _t

                    _t.sleep(0.01)
                    if self._listener._listener is None:  # type: ignore[attr-defined]
                        break
                except Exception:
                    break
                continue
            chan = RpcChannel(conn, name="srv",
                              num_handler_threads=self._num_handler_threads,
                              autostart=False)
            chan.set_handler(self._handler_factory(chan))
            chan.start()
            self._channels.append(chan)

    def close(self) -> None:
        self._stopped.set()
        try:
            self._listener.close()
        except Exception:
            pass
        for ch in self._channels:
            ch.close()


def connect(address, authkey: Optional[bytes] = None,
            handler: Optional[Callable[[str, Any], Any]] = None,
            name: str = "",
            num_handler_threads: Optional[int] = None) -> RpcChannel:
    conn = Client(address, authkey=authkey or cluster_token())
    return RpcChannel(conn, handler=handler, name=name,
                      num_handler_threads=num_handler_threads)
