"""Node agent — joins a head process over TCP and hosts workers + a store.

The remote half of RemoteNode (see remote_node.py). Equivalent of running
the reference's raylet on a joining machine (`ray start --address=...`,
ref: python/ray/scripts/scripts.py:71; python/ray/_private/node.py:1220
start_ray_processes). The agent owns: worker subprocesses (reached over a
local AF_UNIX socket exactly like the in-process Node's), the node's
shared-memory PlasmaStore, and the object-chunk server. All scheduling
stays on the head; the agent executes worker lifecycle commands and relays
workers' core-API calls up the TCP channel.

Object locality: a worker `get` of a non-local object pulls it from the
head in 5 MiB chunks into the LOCAL store first (creating a tracked copy,
ref: object_manager.h:117), then hands the worker a zero-copy local
/dev/shm segment.

Run: python -m ray_tpu_torch.core.node_agent --address HOST:PORT [--num-cpus N]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, Optional

from ..devtools.locks import instrumented_lock
from ..util.retry import RetryPolicy, call_with_retry
from .config import Config
from .ids import NodeId, ObjectId, WorkerId
from .object_store import (make_store, SegmentReader, pull_chunks,
                           read_store_chunk)
from .rpc import RpcChannel, RpcServer, cluster_token, connect


def _outbound_ip_toward(addr) -> str:
    """The local interface address this host would use to reach `addr` —
    the right P2P advertisement when --node-ip isn't given (a UDP connect
    performs routing without sending a packet)."""
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((addr[0], int(addr[1]) or 80))
        return s.getsockname()[0]
    except Exception:
        return "127.0.0.1"
    finally:
        s.close()


class NodeAgent:
    def __init__(self, head_address, resources: Dict[str, float],
                 labels: Optional[Dict[str, str]] = None,
                 session_dir: Optional[str] = None,
                 node_id: Optional[NodeId] = None):
        self.config = Config()
        self.node_id = node_id or NodeId.from_random()
        # a short name under the temp dir (AF_UNIX paths < 108 bytes)
        self.session_dir = session_dir or tempfile.mkdtemp(
            prefix="ray_tpu_torch_agent_")
        os.makedirs(self.session_dir, exist_ok=True)
        self.store = make_store(
            self.node_id,
            capacity_bytes=int(resources.pop("object_store_memory",
                                             self.config.object_store_memory)),
            spill_dir=os.path.join(self.config.object_spilling_dir,
                                   self.node_id.hex()[:8]),
            min_spilling_size=int(self.config.min_spilling_size),
        )
        self.reader = SegmentReader()
        self._lock = instrumented_lock("node_agent", reentrant=True)
        self._procs: Dict[WorkerId, subprocess.Popen] = {}
        self._channels: Dict[WorkerId, RpcChannel] = {}
        # bounded per-worker log ring: the local tail survives head-side
        # eviction / link loss for on-node triage (ref: per-node worker
        # log files in the reference; here in-memory, byte-light)
        from collections import deque as _deque

        self._log_ring_lines = int(self.config.agent_log_ring_lines)
        self._log_rings: Dict[WorkerId, _deque] = {}
        self._stopped = threading.Event()
        self._shutdown_claim = threading.Lock()
        self._drain_deadline = 0.0  # set by the head's "drain" command
        # deterministic fault injection on this agent process too (env is
        # inherited from the launcher): frame-level chaos applies to the
        # agent's head/worker/peer channels
        from .. import chaos as _chaos_mod

        _chaos_mod.maybe_enable_from_env()
        self._sock_path = os.path.join(
            self.session_dir, f"agent_{self.node_id.hex()[:12]}.sock")
        self._server = RpcServer(self._sock_path, self._make_worker_handler,
                                 family="AF_UNIX")
        conn_addr = (tuple(head_address) if isinstance(head_address, list)
                     else head_address)
        # peer-facing object server: other agents pull chunks DIRECTLY from
        # here instead of relaying through the head (ref: object_manager.h:117
        # — raylets push chunks peer-to-peer; head DCN bandwidth must not be
        # the cluster ceiling). Authenticated with the same cluster token.
        # Binds all interfaces; ADVERTISES --node-ip / RTPU_NODE_IP, or the
        # interface this host uses to reach the head (loopback advertisement
        # would silently defeat cross-machine P2P).
        peer_host = (os.environ.get("RTPU_NODE_IP")
                     or _outbound_ip_toward(conn_addr))
        self._peer_server = RpcServer(("0.0.0.0", 0),
                                      self._make_peer_handler,
                                      family="AF_INET",
                                      num_handler_threads=8)
        self._peer_addr = (peer_host, self._peer_server.address[1])
        self._peer_channels: Dict[tuple, RpcChannel] = {}
        # one duplex channel to the head: requests out, commands in.
        # authkey = the cluster token (from --authkey / RTPU_AUTHKEY).
        # Joining retries with backoff (util/retry.py): on pod bring-up
        # the agent routinely starts before the head is listening, and a
        # restarted head should find its agents reconnecting rather than
        # dead (docs/FAULT_TOLERANCE.md).
        self.head = call_with_retry(
            lambda: connect(conn_addr, name="agent",
                            handler=self._handle_head_command,
                            num_handler_threads=8),
            policy=RetryPolicy(initial_backoff_s=0.2, multiplier=2.0,
                               max_backoff_s=2.0, deadline_s=30.0),
            retry_on=(OSError, ConnectionError),
            description=f"agent join {conn_addr}")
        self.head.on_close(self._on_head_lost)
        reply = self.head.call("register_node", {
            "node_id": self.node_id,
            "resources": dict(resources),
            "labels": dict(labels or {}),
            "pid": os.getpid(),
            "object_server_addr": tuple(self._peer_addr),
        }, timeout=30)
        head_period = (reply or {}).get(
            "health_check_period_s", self.config.health_check_period_s)
        # periodic liveness signal; a hung/partitioned agent (channel still
        # open, nothing flowing) is declared dead by the head's health
        # monitor when these stop (ref: gcs_health_check_manager.h:39)
        threading.Thread(target=self._heartbeat_loop, args=(head_period,),
                         daemon=True, name="agent-heartbeat").start()

    def _heartbeat_loop(self, period_s: float) -> None:
        period = max(0.05, float(period_s) / 2)
        backlog: list = []  # deltas snapshotted but not yet shipped
        while not self._stopped.is_set() and not self.head.closed:
            try:
                # piggyback this agent process's metric deltas (store
                # ops, RPC latency) on the liveness signal — the head
                # merges them node-tagged into its /metrics exposition
                from ..util import metrics as metrics_mod

                try:
                    backlog = metrics_mod.carry_backlog(backlog)
                except Exception:
                    pass
                if self.head.closed:
                    break
                self.head.notify("heartbeat", backlog or None)
                backlog = []
            except Exception:
                break  # channel closed mid-send; head loss handler runs
            self._stopped.wait(period)

    # ---- commands from the head ---------------------------------------------

    def _handle_head_command(self, method: str, payload):
        if method == "start_worker":
            self._start_worker(payload["worker_id"],
                               container=payload.get("container"))
            return True
        if method == "push_task":
            ch = self._channels.get(payload["worker_id"])
            if ch is None or ch.closed:
                self.head.notify("worker_exit",
                                 {"worker_id": payload["worker_id"]})
                return False
            ch.notify("push_task", payload["spec"])
            return True
        if method == "kill_worker":
            self._kill_worker(payload["worker_id"], payload.get("force", True))
            return True
        if method == "store_delete":
            self.store.delete(payload["object_id"])
            return True
        if method == "store_stats":
            return self.store.stats()
        if method == "worker_stack":
            # on-demand stack dump relay: head -> this agent -> worker
            # (remote workers have no head-side channel; ref: `ray stack`
            # fans out through each node's agent)
            ch = self._channels.get(payload["worker_id"])
            if ch is None or ch.closed:
                raise RuntimeError("worker is not connected to this agent")
            return ch.call("dump_stacks", None,
                           timeout=float(payload.get("timeout", 5.0)))
        if method == "worker_profile":
            ch = self._channels.get(payload["worker_id"])
            if ch is None or ch.closed:
                raise RuntimeError("worker is not connected to this agent")
            duration = float(payload.get("duration_s", 5.0))
            return ch.call("profile",
                           {"duration_s": duration,
                            "interval_s": payload.get("interval_s", 0.01)},
                           timeout=duration + 30.0)
        if method == "agent_logs":
            # the local per-worker ring (head-store-independent tail)
            wid = payload.get("worker_id")
            with self._lock:
                rings = ([self._log_rings.get(wid)] if wid is not None
                         else list(self._log_rings.values()))
            out = []
            for ring in rings:
                if ring:
                    out.extend(list(ring))
            return out[-int(payload.get("limit", 1000)):]
        if method == "object_info":
            seg = self.store.get_segment(payload["object_id"])
            return None if seg is None else seg[1]
        if method == "read_chunk":
            return self._read_chunk(payload["object_id"], payload["offset"],
                                    payload["length"])
        if method == "store_put_chunk":
            # head -> agent object push (the inverse of read_chunk; lets
            # the head place a driver put on this node's store)
            return self.store.put_chunk(
                payload["object_id"], payload["offset"], payload["total"],
                payload["data"])
        if method == "worker_notify":
            # generic head -> worker oneway relay (compiled-graph envelope
            # delivery and stop fencing ride this)
            ch = self._channels.get(payload["worker_id"])
            if ch is not None and not ch.closed:
                ch.notify(payload["method"], payload["payload"])
            return None
        if method == "worker_relay_call":
            # generic head -> worker request relay (cgraph_load/stop —
            # same shape as the worker_stack introspection relay)
            ch = self._channels.get(payload["worker_id"])
            if ch is None or ch.closed:
                raise RuntimeError("worker is not connected to this agent")
            return ch.call(payload["method"], payload["payload"],
                           timeout=float(payload.get("timeout", 30.0)))
        if method == "cgraph_alloc_channel":
            # compiled-graph channel segment on THIS node's store: both
            # endpoints are workers on this host; the head only needs the
            # shm name for their plans
            return self.store.allocate_channel(payload["cid"],
                                               payload["size"])
        if method == "cgraph_release_channel":
            self.store.release_channel(payload["cid"])
            return True
        if method == "drain":
            # preemption notice relayed by the head (docs/FAULT_TOLERANCE
            # "Elasticity"): the platform kills this host in grace_s. The
            # head already stopped scheduling here; usually the autoscaler
            # terminates us cleanly once the workloads drained. This is
            # the backstop: exit gracefully just BEFORE the axe so the
            # head sees an orderly channel close, never a mid-write kill.
            grace = max(0.0, float(payload.get("grace_s", 0.0)))
            self._drain_deadline = time.monotonic() + grace

            def _drain_backstop():
                wait = max(0.0, grace - max(1.0, 0.1 * grace)) \
                    if grace > 1.5 else grace * 0.9
                if not self._stopped.wait(wait):
                    self.shutdown(kill=False)

            threading.Thread(target=_drain_backstop, daemon=True,
                             name="agent-drain").start()
            return True
        if method == "shutdown":
            threading.Thread(target=self.shutdown,
                             kwargs={"kill": payload.get("kill", False)},
                             daemon=True).start()
            return True
        raise ValueError(f"unknown head command {method}")

    def _read_chunk(self, oid: ObjectId, offset: int, length: int):
        return read_store_chunk(self.store, self.reader, oid, offset, length)

    # ---- peer-to-peer object serving ----------------------------------------

    def _make_peer_handler(self, channel: RpcChannel):
        def handler(method: str, payload):
            if method == "object_info":
                seg = self.store.get_segment(payload["object_id"])
                return None if seg is None else seg[1]
            if method == "read_chunk":
                return self._read_chunk(payload["object_id"],
                                        payload["offset"], payload["length"])
            raise ValueError(f"unknown peer message {method}")

        return handler

    # peer reconnect policy (util/retry.py): an accept-backlog refusal
    # on a busy holder must not immediately push the pull onto the head
    # relay, but a truly dead peer should fail over fast
    _PEER_CONNECT = RetryPolicy(initial_backoff_s=0.05, multiplier=2.0,
                                max_backoff_s=0.4, max_attempts=3)

    def _peer_channel(self, addr: tuple) -> RpcChannel:
        with self._lock:
            ch = self._peer_channels.get(addr)
            if ch is not None and not ch.closed:
                return ch
        ch = call_with_retry(
            lambda: connect(addr, name="peer", num_handler_threads=2),
            policy=self._PEER_CONNECT,
            retry_on=(OSError, ConnectionError),
            description=f"peer connect {addr}")
        with self._lock:
            old = self._peer_channels.get(addr)
            if old is not None and not old.closed:
                ch.close()
                return old
            self._peer_channels[addr] = ch
        return ch

    def _pull_from_peers(self, oid: ObjectId, peers) -> Optional[bytes]:
        """Try each holder's object server in turn; None = no peer could
        serve it (caller falls back to the head relay)."""
        for addr in peers:
            try:
                ch = self._peer_channel(tuple(addr))
                size = ch.call("object_info", {"object_id": oid}, timeout=30)
                if size is None:
                    continue  # holder evicted it since the head looked
                data = pull_chunks(
                    lambda off, n, ch=ch: ch.call(
                        "read_chunk",
                        {"object_id": oid, "offset": off, "length": n},
                        timeout=120),
                    size)
                if data is not None:
                    return data
            except Exception:
                continue  # peer unreachable/dying: next copy or fallback
        return None

    # ---- worker lifecycle ----------------------------------------------------

    def _start_worker(self, worker_id: WorkerId,
                      container: dict | None = None) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        env["RTPU_AUTHKEY"] = cluster_token().hex()  # env, never argv
        cmd = [
            sys.executable, "-S", "-m", "ray_tpu_torch.core.worker_main",
            "--address", self._sock_path,
            "--worker-id", worker_id.hex(),
            "--node-id", self.node_id.hex(),
        ]
        if container:
            # same launcher contract as Node._start_worker, on THIS host
            from .runtime_env import container_command

            cmd = container_command(self.config.container_launcher,
                                    container, cmd)
        try:
            proc = subprocess.Popen(cmd, env=env)
        except OSError as e:
            # launcher missing/unexecutable: report the launch failure so
            # the head releases the 'starting' slot and fails the lease
            # instead of waiting forever for a register
            if not self._stopped.is_set() and not self.head.closed:
                self.head.notify("worker_exit", {
                    "worker_id": worker_id,
                    "error": f"worker launch failed ({cmd[0]}): {e}"})
            return
        with self._lock:
            self._procs[worker_id] = proc
        threading.Thread(target=self._reap, args=(worker_id, proc),
                         daemon=True).start()

    def _reap(self, worker_id: WorkerId, proc: subprocess.Popen) -> None:
        try:
            proc.wait()
        except Exception:
            return
        with self._lock:
            self._procs.pop(worker_id, None)
            self._channels.pop(worker_id, None)
        if not self._stopped.is_set() and not self.head.closed:
            self.head.notify("worker_exit", {"worker_id": worker_id})

    def _kill_worker(self, worker_id: WorkerId, force: bool) -> None:
        with self._lock:
            proc = self._procs.get(worker_id)
            ch = self._channels.get(worker_id)
        if not force and ch is not None:
            ch.notify("shutdown")
            ch.close()
        if proc is not None:
            try:
                (proc.kill if force else proc.terminate)()
            except Exception:
                pass

    # ---- worker-facing handler (relay) --------------------------------------

    def _make_worker_handler(self, channel: RpcChannel):
        state = {"worker_id": None}

        def handler(method: str, payload):
            if method == "register":
                wid: WorkerId = payload["worker_id"]
                state["worker_id"] = wid
                with self._lock:
                    self._channels[wid] = channel
                channel.on_close(lambda: self._on_worker_channel_close(wid))
                self.head.call("worker_register",
                               {"worker_id": wid,
                                "pid": payload.get("pid", 0),
                                "direct_addr": payload.get("direct_addr")},
                               timeout=30)
                # prints from workers on this host can't reach the driver's
                # console — have them tee lines up the channel
                return {"forward_logs": True}
            wid = state["worker_id"]
            if method == "create_object":
                return self.store.create(payload["object_id"], payload["size"])
            if method == "seal_object":
                self.store.seal(payload["object_id"])
                self.store.pin(payload["object_id"])
                self.head.notify("object_sealed", {
                    "object_id": payload["object_id"],
                    "worker_id": wid,
                    "is_put": bool(payload.get("is_put")),
                    "size": self.store.object_size(payload["object_id"]),
                })
                return True
            if method == "task_done":
                self.head.notify("task_done", {"worker_id": wid,
                                               "payload": payload})
                return None
            if method == "get_objects":
                return self._get_objects(payload["ids"],
                                         payload.get("timeout"))
            if method in ("log_event", "worker_log", "metrics_push",
                          "task_events_batch"):
                if method == "worker_log":
                    from collections import deque as _deque

                    with self._lock:
                        ring = self._log_rings.get(wid)
                        if ring is None:
                            # rings outlive their worker (post-mortem
                            # tail) but the table stays bounded: evict
                            # a dead worker's ring past the cap
                            if len(self._log_rings) >= 64:
                                for old in list(self._log_rings):
                                    if old not in self._channels:
                                        self._log_rings.pop(old, None)
                                        break
                            ring = self._log_rings[wid] = _deque(
                                maxlen=self._log_ring_lines)
                        whex = wid.hex() if wid is not None else ""
                        for rec in payload.get("recs", ()):
                            ring.append({"worker_id": whex,
                                         "pid": payload.get("pid"),
                                         "rec": list(rec)})
                self.head.notify("worker_call", {"worker_id": wid,
                                                 "method": method,
                                                 "payload": payload})
                return None
            # everything else: relay to the head's core-worker API
            from .rpc import ChannelClosed

            try:
                return self.head.call("worker_call", {"worker_id": wid,
                                                      "method": method,
                                                      "payload": payload})
            except ChannelClosed:
                if self._stopped.is_set() or self.head.closed:
                    return None  # agent shutting down; drop the relay
                raise

        return handler

    def _on_worker_channel_close(self, worker_id: WorkerId) -> None:
        with self._lock:
            self._channels.pop(worker_id, None)
        if not self._stopped.is_set() and not self.head.closed:
            self.head.notify("worker_exit", {"worker_id": worker_id})

    # ---- object pulls --------------------------------------------------------

    def _get_objects(self, ids, timeout):
        out = []
        for oid in ids:
            seg = self.store.get_segment(oid)
            if seg is not None:
                out.append(("shm", seg[0], seg[1]))
                continue
            res = self.head.call("fetch_for_agent",
                                 {"object_id": oid, "timeout": timeout},
                                 timeout=None if timeout is None
                                 else timeout + 30)
            kind = res[0]
            if kind == "inline":
                out.append(res)
                continue
            data = None
            if kind == "remote":
                # the head answered with LOCATIONS: pull chunks directly
                # from a holding agent (P2P); the head never touches the
                # bytes (ref: object_manager.h:117)
                data = self._pull_from_peers(oid, res[1])
                if data is None:
                    # every peer failed: ask the head to relay (it pulls
                    # the object into its own store and serves chunks)
                    res = self.head.call(
                        "fetch_for_agent",
                        {"object_id": oid, "timeout": timeout,
                         "relay": True},
                        timeout=None if timeout is None else timeout + 30)
                    if res[0] == "inline":
                        out.append(res)
                        continue
            if data is None:
                # ("sized", total): pull chunks from the head's store
                data = pull_chunks(
                    lambda off, n: self.head.call(
                        "head_read_chunk",
                        {"object_id": oid, "offset": off, "length": n},
                        timeout=120),
                    res[1])
            if data is None:
                raise RuntimeError(
                    f"object {oid.hex()[:12]} vanished mid-transfer")
            self.store.put_bytes(oid, data, pin=True)
            self.head.notify("object_copy", {"object_id": oid})
            seg = self.store.get_segment(oid)
            out.append(("shm", seg[0], seg[1]))
        return out

    # ---- lifecycle -----------------------------------------------------------

    def _on_head_lost(self) -> None:
        if not self._stopped.is_set():
            self.shutdown(kill=True)

    def shutdown(self, kill: bool = False) -> None:
        # atomic claim: the head-loss callback, a head "shutdown" command,
        # and SIGINT can all race here — exactly one caller runs the body
        # (Event.is_set()+set() as two steps let two callers both enter)
        with self._shutdown_claim:
            if self._stopped.is_set():
                return
            self._stopped.set()
        with self._lock:
            procs = dict(self._procs)
            channels = dict(self._channels)
            peer_channels = dict(self._peer_channels)
        for ch in peer_channels.values():
            try:
                ch.close()
            except Exception:
                pass
        try:
            self._peer_server.close()
        except Exception:
            pass
        for ch in channels.values():
            try:
                ch.notify("shutdown")
                ch.close()
            except Exception:
                pass
        for proc in procs.values():
            try:
                (proc.kill if kill else proc.terminate)()
            except Exception:
                pass
        for proc in procs.values():
            try:
                proc.wait(timeout=5)
            except Exception:
                pass
        self._server.close()
        try:
            self.head.close()
        except Exception:
            pass
        self.store.destroy()

    def wait(self) -> None:
        """Block until shut down (the agent main loop)."""
        while not self._stopped.is_set():
            time.sleep(0.2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ray_tpu_torch node agent")
    p.add_argument("--address", required=True,
                   help="head host:port to join")
    p.add_argument("--num-cpus", type=float, default=float(os.cpu_count() or 1))
    p.add_argument("--resources", default="{}",
                   help="extra resources as JSON, e.g. '{\"TPU\": 4}'")
    p.add_argument("--labels", default="{}")
    p.add_argument("--node-id", default="",
                   help="hex node id assigned by the launcher (optional)")
    p.add_argument("--authkey", default="",
                   help="cluster auth token (hex) from the head's join "
                        "command; RTPU_AUTHKEY env is the alternative")
    p.add_argument("--node-ip", default="",
                   help="address other agents use to reach this node's "
                        "object server (default: auto-detect the interface "
                        "facing the head)")
    args = p.parse_args(argv)
    if args.authkey:
        os.environ["RTPU_AUTHKEY"] = args.authkey
    if args.node_ip:
        os.environ["RTPU_NODE_IP"] = args.node_ip
    host, _, port = args.address.rpartition(":")
    resources = {"CPU": args.num_cpus, **json.loads(args.resources)}
    agent = NodeAgent((host, int(port)), resources,
                      labels=json.loads(args.labels),
                      node_id=NodeId(bytes.fromhex(args.node_id))
                      if args.node_id else None)
    from ..util.logs import get_logger

    get_logger("ray_tpu_torch.agent").info(
        "node agent %s joined %s", agent.node_id.hex()[:12], args.address)
    try:
        agent.wait()
    except KeyboardInterrupt:
        agent.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
