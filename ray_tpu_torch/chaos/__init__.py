"""Deterministic, seeded fault injection threaded through the runtime.

The chaos layer (ref: Jepsen/chaos-mesh style nemeses, and the reference
repo's ``RAY_testing_*`` fault-injection flags in ray_config_def.h) turns
the failure modes a preemptible TPU-pod deployment actually sees —
dropped control frames, slow links, duplicated deliveries, worker and
agent death, poisoned channels, failed object pulls — into a
*replayable* schedule: every probabilistic draw comes from a per-point
RNG seeded by ``(plan.seed, point)``, and every kill fires at a fixed
offset from :func:`enable`, so a failing CI run reproduces with the same
``RAY_TPU_CHAOS`` spec.

Plan spec (env ``RAY_TPU_CHAOS`` or :meth:`ChaosPlan.parse`), entries
separated by ``;``::

    seed=42                       fixed RNG seed (default 0)
    rpc_drop=0.05                 drop 5% of oneway frames (send side)
    rpc_drop=0.05:direct_result   ...only frames whose method contains
                                  "direct_result"
    rpc_delay=0.1@0.02            10% of writer flushes sleep 20ms
    rpc_dup=0.02                  duplicate 2% of oneway frames
    rpc_reorder=0.05              swap adjacent oneway frames in a batch
    recv_drop=0.01                drop oneway frames at the receiver
    pull_fail=0.2                 20% of remote object pulls raise a
                                  transient error (the retry path runs)
    channel_poison=0.001:c0->c1   poison matching cgraph channels
    kill=actor:trainer@5.0        kill the named actor 5s after enable
    kill=worker@7.5               kill a seeded-random live worker at 7.5s
    preempt=node:ab12@5+2.0       scheduled preemption of the node whose
                                  id starts ab12: NOTICE at t=5 (the
                                  NODE_PREEMPTING drain path runs), then
                                  SIGKILL of its agent at t=5+2.0 —
                                  scale-down rehearsals, seeded and
                                  replayable like every other fault

Only ONEWAY frames are droppable/duplicable: dropping a request or
response frame models a hang the channel layer has no retransmit for
(the real-world analog is a TCP connection that died, which surfaces as
a channel close, not a silent void). Delays and reorders apply to any
frame. This matches where the recovery machinery lives: direct submits,
direct results, cgraph pushes, task_done floods, and heartbeats all ride
oneway frames.

Zero overhead when disabled: host modules (core.rpc, core.runtime,
cgraph.channel) carry a module-level ``_CHAOS`` that is ``None`` until
:func:`enable` installs the engine — the hot paths pay one global
is-None test, and nothing imports this package until chaos is asked for.

Metrics: every injection counts in
``ray_tpu_chaos_injected_total{kind}``.
"""
from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

from ..util import metrics as _metrics

__all__ = [
    "ChaosRule", "KillSpec", "PreemptSpec", "ChaosPlan", "ChaosEngine",
    "enable", "disable", "is_enabled", "engine",
    "plan_from_env", "maybe_enable_from_env", "ENV_VAR",
]

ENV_VAR = "RAY_TPU_CHAOS"

_C_INJECTED = _metrics.Counter(
    "ray_tpu_chaos_injected_total",
    "faults injected by the chaos layer", tag_keys=("kind",))

_RULE_KINDS = ("rpc_drop", "rpc_delay", "rpc_dup", "rpc_reorder",
               "recv_drop", "pull_fail", "channel_poison")


@dataclass(frozen=True)
class ChaosRule:
    kind: str            # one of _RULE_KINDS
    prob: float          # injection probability per opportunity
    param: float = 0.0   # kind-specific (delay seconds)
    match: str = ""      # substring filter on method/edge ("" = all)

    def matches(self, label: str) -> bool:
        return not self.match or self.match in label


@dataclass(frozen=True)
class KillSpec:
    at_s: float
    # "actor:<name-or-hex-prefix>" | "actor" (seeded random) |
    # "worker" | "worker:<hex-prefix>" | a callable for programmatic
    # plans (invoked with the runtime)
    target: Union[str, Callable[[Any], None]] = "worker"


@dataclass(frozen=True)
class PreemptSpec:
    """Scheduled node preemption: notice at ``at_s`` (the runtime's
    ``NODE_PREEMPTING`` drain path runs — scheduler drain filter, serve
    replica draining, pipeline shrink-before-the-axe), SIGKILL of the
    node's agent process at ``at_s + grace_s`` whether or not anyone
    drained. Target: "node:<hex-prefix>" or "node" (seeded random
    remote node)."""

    at_s: float
    grace_s: float = 5.0
    target: str = "node"


@dataclass(frozen=True)
class ChaosPlan:
    seed: int = 0
    rules: tuple = ()
    kills: tuple = ()
    preempts: tuple = ()

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        seed = 0
        rules: List[ChaosRule] = []
        kills: List[KillSpec] = []
        preempts: List[PreemptSpec] = []
        for raw in spec.split(";"):
            entry = raw.strip()
            if not entry:
                continue
            key, _, value = entry.partition("=")
            key = key.strip()
            value = value.strip()
            if key == "seed":
                seed = int(value)
            elif key == "kill":
                target, _, at = value.partition("@")
                kills.append(KillSpec(at_s=float(at or 0.0),
                                      target=target))
            elif key == "preempt":
                # preempt=node:<id>@t+grace — notice at t, axe at t+grace
                target, _, timing = value.partition("@")
                at_s, _, grace = timing.partition("+")
                preempts.append(PreemptSpec(
                    at_s=float(at_s or 0.0),
                    grace_s=float(grace) if grace else 5.0,
                    target=target or "node"))
            elif key in _RULE_KINDS:
                body, _, match = value.partition(":")
                prob_s, _, param_s = body.partition("@")
                rules.append(ChaosRule(
                    kind=key, prob=float(prob_s),
                    param=float(param_s) if param_s else 0.0,
                    match=match))
            else:
                raise ValueError(
                    f"unknown chaos spec entry {entry!r} (known: seed, "
                    f"kill, preempt, {', '.join(_RULE_KINDS)})")
        return cls(seed=seed, rules=tuple(rules), kills=tuple(kills),
                   preempts=tuple(preempts))


class ChaosEngine:
    """Live injector for one plan. Each (rule index, kind) gets its own
    seeded RNG + lock, so a rule's draw sequence depends only on how many
    opportunities ITS injection point saw — not on interleaving with
    other points."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self._by_kind: Dict[str, List[ChaosRule]] = {}
        for r in plan.rules:
            self._by_kind.setdefault(r.kind, []).append(r)
        self._rngs: Dict[ChaosRule, random.Random] = {}
        self._rng_locks: Dict[ChaosRule, threading.Lock] = {}
        for i, r in enumerate(plan.rules):
            self._rngs[r] = random.Random(f"{plan.seed}/{i}/{r.kind}")
            self._rng_locks[r] = threading.Lock()
        self._kill_rng = random.Random(f"{plan.seed}/kill")
        self._preempt_victims: Dict[PreemptSpec, Any] = {}
        self.injected: Dict[str, int] = {}
        self._inj_lock = threading.Lock()
        self._stop = threading.Event()
        self._kill_thread: Optional[threading.Thread] = None
        self.t0 = time.monotonic()

    # -- draw machinery ----------------------------------------------------

    def _fire(self, rule: ChaosRule, label: str) -> bool:
        if not rule.matches(label):
            return False
        with self._rng_locks[rule]:
            hit = self._rngs[rule].random() < rule.prob
        if hit:
            self.record(rule.kind)
        return hit

    def record(self, kind: str) -> None:
        with self._inj_lock:
            self.injected[kind] = self.injected.get(kind, 0) + 1
        _C_INJECTED.inc(tags={"kind": kind})

    def _first_hit(self, kind: str, label: str) -> Optional[ChaosRule]:
        for rule in self._by_kind.get(kind, ()):
            if self._fire(rule, label):
                return rule
        return None

    # -- RPC frame hooks (core/rpc.py writer drain + oneway dispatch) ------

    _ONEWAY = 3  # mirrors rpc._ONEWAY; rpc is not imported here

    def rpc_send(self, msgs: list) -> list:
        """Transform one writer-lane flush: msgs are decoded frame tuples
        ``(kind, msg_id, method, payload)``. Runs on a pool thread, so a
        delay here stalls exactly this channel's writer — the fault being
        modeled. Drop/dup/reorder touch ONEWAY frames only."""
        if not self._by_kind:
            return msgs
        delay = 0.0
        out: list = []
        for msg in msgs:
            kind = msg[0]
            method = msg[2] if isinstance(msg[2], str) else ""
            rule = self._first_hit("rpc_delay", method)
            if rule is not None:
                delay = max(delay, rule.param or 0.001)
            if kind != self._ONEWAY:
                out.append(msg)
                continue
            if self._first_hit("rpc_drop", method) is not None:
                continue
            out.append(msg)
            if self._first_hit("rpc_dup", method) is not None:
                out.append(msg)
            if len(out) >= 2 and out[-2][0] == self._ONEWAY \
                    and self._first_hit("rpc_reorder", method) is not None:
                out[-1], out[-2] = out[-2], out[-1]
        if delay > 0:
            time.sleep(delay)
        return out

    def recv_drop(self, method: str) -> bool:
        """Receiver-side oneway drop (models a frame lost after the
        sender's syscall succeeded)."""
        return self._first_hit("recv_drop", method or "") is not None

    # -- object-store pull hook (core/runtime.py _pull_once) ---------------

    def pull_fail(self, label: str = "") -> bool:
        return self._first_hit("pull_fail", label) is not None

    # -- cgraph channel hook (cgraph/channel.py send) ----------------------

    def channel_poison(self, edge: str) -> bool:
        return self._first_hit("channel_poison", edge or "") is not None

    # -- kill schedule -----------------------------------------------------

    def start_kills(self, runtime) -> None:
        if (not self.plan.kills and not self.plan.preempts) \
                or self._kill_thread is not None:
            return
        self._kill_thread = threading.Thread(
            target=self._kill_loop, args=(runtime,), daemon=True,
            name="chaos-kills")
        self._kill_thread.start()

    def _kill_loop(self, runtime) -> None:
        # one merged timeline: kills fire once; each preempt expands to
        # a NOTICE event at t and an AXE event at t+grace — the axe
        # falls whether or not anything drained (spot semantics)
        events = [(spec.at_s, "kill", spec) for spec in self.plan.kills]
        for spec in self.plan.preempts:
            events.append((spec.at_s, "preempt_notice", spec))
            events.append((spec.at_s + spec.grace_s, "preempt_kill",
                           spec))
        for at_s, kind, spec in sorted(events, key=lambda e: e[0]):
            wait = self.t0 + at_s - time.monotonic()
            if wait > 0 and self._stop.wait(wait):
                return
            if self._stop.is_set():
                return
            try:
                if kind == "kill":
                    self._execute_kill(runtime, spec)
                elif kind == "preempt_notice":
                    self._execute_preempt_notice(runtime, spec)
                else:
                    self._execute_preempt_kill(runtime, spec)
                self.record(kind)
            except Exception:
                import traceback

                traceback.print_exc()

    def _execute_kill(self, runtime, spec: KillSpec) -> None:
        if callable(spec.target):
            spec.target(runtime)
            return
        kind, _, sel = spec.target.partition(":")
        if kind == "actor":
            self._kill_actor(runtime, sel)
        elif kind == "worker":
            self._kill_worker(runtime, sel)
        else:
            raise ValueError(f"unknown kill target {spec.target!r}")

    def _kill_actor(self, runtime, sel: str) -> None:
        from ..core.gcs import ActorState

        if sel:
            info = runtime.gcs.get_named_actor(sel, runtime.namespace)
            if info is None:
                # hex-prefix match over live actors
                cands = [i for i in runtime.gcs.list_actors()
                         if i.state == ActorState.ALIVE
                         and i.actor_id.hex().startswith(sel)]
                info = cands[0] if cands else None
            if info is None:
                raise ValueError(f"chaos kill: no actor matches {sel!r}")
            runtime.kill_actor(info.actor_id, no_restart=False)
            return
        cands = sorted(
            (i for i in runtime.gcs.list_actors()
             if i.state == ActorState.ALIVE),
            key=lambda i: i.actor_id.hex())
        if not cands:
            raise ValueError("chaos kill: no live actor to kill")
        victim = cands[self._kill_rng.randrange(len(cands))]
        runtime.kill_actor(victim.actor_id, no_restart=False)

    def _kill_worker(self, runtime, sel: str) -> None:
        """SIGKILL a live worker process (preemption model). Selection is
        seeded-random over workers with a local process handle, or by
        worker-id hex prefix."""
        import signal

        cands = []
        for node in getattr(runtime, "nodes", {}).values():
            for w in getattr(node, "_workers", {}).values():
                proc = getattr(w, "proc", None)
                if proc is None or proc.poll() is not None:
                    continue
                if sel and not w.worker_id.hex().startswith(sel):
                    continue
                cands.append(proc)
        if not cands:
            raise ValueError(
                f"chaos kill: no live local worker matches {sel!r}")
        cands.sort(key=lambda p: p.pid)
        victim = cands[self._kill_rng.randrange(len(cands))]
        os.kill(victim.pid, signal.SIGKILL)

    # -- preempt schedule (notice at t, SIGKILL at t+grace) ----------------

    def _resolve_preempt_node(self, runtime, spec: PreemptSpec):
        kind, _, sel = spec.target.partition(":")
        if kind != "node":
            raise ValueError(
                f"preempt target must be node[:<hex-prefix>], got "
                f"{spec.target!r}")
        cands = sorted(
            (node for node in getattr(runtime, "nodes", {}).values()
             if node.alive and getattr(node, "is_remote", False)
             and (not sel or node.node_id.hex().startswith(sel))),
            key=lambda n: n.node_id.hex())
        if not cands:
            raise ValueError(
                f"chaos preempt: no live remote node matches {sel!r}")
        if sel:
            return cands[0]
        return cands[self._kill_rng.randrange(len(cands))]

    def _execute_preempt_notice(self, runtime, spec: PreemptSpec) -> None:
        node = self._resolve_preempt_node(runtime, spec)
        # remember the victim so the axe hits the SAME node the notice
        # named even if other nodes joined/left in the grace window
        self._preempt_victims[spec] = node.node_id
        runtime.on_preemption_notice(node.node_id, spec.grace_s,
                                     reason="chaos preempt schedule")

    def _execute_preempt_kill(self, runtime, spec: PreemptSpec) -> None:
        import signal

        node_id = self._preempt_victims.pop(spec, None)
        node = runtime.nodes.get(node_id) if node_id is not None else None
        if node is None or not node.alive:
            return  # drained and exited before the axe: nothing to kill
        proc = getattr(node, "_agent_proc", None)
        if proc is not None and proc.poll() is None:
            os.kill(proc.pid, signal.SIGKILL)
        else:
            # no local process handle (agent launched elsewhere): model
            # the platform kill head-side — channel loss semantics
            runtime.on_remote_node_lost(node_id)

    def stop(self) -> None:
        self._stop.set()


# ---------------------------------------------------------------------------
# global enable/disable — installs hooks into the host modules
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_ENGINE: Optional[ChaosEngine] = None


def enable(plan: Union[ChaosPlan, str], runtime=None) -> ChaosEngine:
    """Install the plan's hooks process-wide and start its kill schedule
    (when a runtime is given). Idempotent per plan object; re-enabling
    replaces the previous engine."""
    global _ENGINE
    if isinstance(plan, str):
        plan = ChaosPlan.parse(plan)
    eng = ChaosEngine(plan)
    with _LOCK:
        if _ENGINE is not None:
            _ENGINE.stop()
        _ENGINE = eng
    _install_hooks(eng)
    if runtime is not None:
        eng.start_kills(runtime)
    return eng


def disable() -> None:
    global _ENGINE
    with _LOCK:
        eng, _ENGINE = _ENGINE, None
    if eng is not None:
        eng.stop()
    _install_hooks(None)


def is_enabled() -> bool:
    return _ENGINE is not None


def engine() -> Optional[ChaosEngine]:
    return _ENGINE


def _install_hooks(eng: Optional[ChaosEngine]) -> None:
    from ..cgraph import channel as channel_mod
    from ..core import rpc as rpc_mod
    from ..core import runtime as runtime_mod

    rpc_mod._CHAOS = eng
    runtime_mod._CHAOS = eng
    channel_mod._CHAOS = eng


def plan_from_env() -> Optional[ChaosPlan]:
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return None
    return ChaosPlan.parse(spec)


def maybe_enable_from_env(runtime=None) -> Optional[ChaosEngine]:
    """Called at process bring-up (driver runtime, node agent, worker):
    installs the env-specified plan, if any. Each process draws from its
    own RNGs — determinism is per-process, per-point."""
    plan = plan_from_env()
    if plan is None:
        return None
    return enable(plan, runtime=runtime)
