"""Actor-hosted pipeline parallelism: 1F1B microbatch schedule over stage
actors (counterpart of ray_tpu/train/pipeline_engine.py).

Each stage lives in its own actor — its own process — with activations
flowing through the object store as CPU tensors. The compiled-graph
engine (``pipeline_cgraph.CompiledPipelineEngine``) runs the same chunk
programs over pre-allocated channels and is the one to train with; this
dynamic engine submits one ``.remote()`` call per op and stays as the
simpler baseline.

Scheduling note: the runtime's actor queues execute strictly in submission
order (core/worker_main.py ActorQueue), so submitting each stage's ops in
1F1B order pins the schedule, while ObjectRef arguments give exact
cross-stage dataflow sync — fwd(i, mb) waits on fwd(i-1, mb), bwd(i, mb)
waits on bwd(i+1, mb). No barriers, no polling.

The stage programs are ``pipeline_cgraph``'s autograd programs, and ``tx``
is its optimizer factory (a picklable callable building a
``torch.optim.Optimizer`` over a list of tensors); each stage runs on
``device`` (None = the CUDA card; ``"cpu"`` where there is none).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import ray_tpu_torch
from ray_tpu_torch._vendor import cloudpickle
from ray_tpu_torch.core.placement_group import (placement_group,
                                                remove_placement_group)

from ..parallel.pipeline import schedule_1f1b


class _StageActor:
    """One pipeline stage: holds its parameter shard, runs the
    per-microbatch forward (saving its autograd residual — the 1F1B
    in-flight activation memory), backward (popping it), and the
    optimizer step on locally-accumulated grads."""

    def setup(self, stage_idx: int, num_stages: int, fn_blob: bytes,
              params: Any, tx_blob: Optional[bytes],
              device: Optional[str] = None) -> bool:
        from .._device import resolve_device
        from ..parallel.zero import tree_flatten
        from .pipeline_cgraph import _make_programs, _to

        self.idx = stage_idx
        self.num_stages = num_stages
        self.is_last = stage_idx == num_stages - 1
        self.device = resolve_device(device)
        self.fwd, self.bwd = _make_programs(cloudpickle.loads(fn_blob),
                                            self.is_last, False)
        self.params = _to(params, self.device)
        self._leaves = tree_flatten(self.params)[0]
        tx = cloudpickle.loads(tx_blob) if tx_blob else None
        self._opt = tx(self._leaves) if tx is not None else None
        self._residuals = {}
        self._grad_acc = None
        return True

    def forward(self, mb: int, x, targets=None):
        """Returns the stage output (activation for the next stage, as a
        CPU tensor; the loss as a float on the last stage). Residuals stay
        here."""
        from .pipeline_cgraph import _to

        x = _to(x, self.device)
        if self.is_last:
            out, res = self.fwd(self.params, x, _to(targets, self.device))
        else:
            out, res = self.fwd(self.params, x)
        self._residuals[mb] = res
        self.peak_in_flight = max(getattr(self, "peak_in_flight", 0),
                                  len(self._residuals))
        return float(out) if self.is_last else out.cpu()

    def backward(self, mb: int, g=None):
        """g: cotangent from the next stage (None on the last stage — the
        loss seeds with 1.0). Returns the cotangent for the previous
        stage (None on stage 0) and accumulates this stage's param
        grads."""
        from ..parallel.zero import tree_map
        from .pipeline_cgraph import _seed, _to

        res = self._residuals.pop(mb)
        g = _seed(self.device) if g is None else _to(g, self.device)
        gp, gx = self.bwd(res, g)
        if self._grad_acc is None:
            self._grad_acc = gp
        else:
            self._grad_acc = tree_map(lambda a, b: a + b, self._grad_acc,
                                      gp)
        return None if gx is None else gx.cpu()

    def apply_grads(self, scale: float = 1.0) -> bool:
        from ..parallel.zero import tree_map
        from .pipeline_cgraph import _opt_step

        if self._opt is not None:
            _opt_step(self._opt, self._leaves,
                      tree_map(lambda g: g * scale, self._grad_acc))
        self._grad_acc = None
        return True

    def in_flight(self) -> int:
        """Number of saved fwd residuals (0 after a drained step)."""
        return len(self._residuals)

    def max_in_flight(self) -> int:
        """Peak saved residual count across the run — tests assert the
        1F1B memory bound (<= num_stages - idx) against this; a GPipe
        regression (all fwds before any bwd) would blow it to M."""
        return getattr(self, "peak_in_flight", 0)

    def get_grad(self, key: str):
        return self._grad_acc[key].cpu()

    def add_grad(self, key: str, g) -> bool:
        from .pipeline_cgraph import _to

        self._grad_acc[key] = self._grad_acc[key] + _to(g, self.device)
        return True

    def get_params(self):
        from .pipeline_cgraph import _host

        return _host(self.params)


class PipelineEngine:
    """Drives P stage actors through the 1F1B schedule.

    stage_fns: P callables. Stages 0..P-2: fn(params, x) -> activation.
        The last stage: fn(params, x, targets) -> scalar loss (mean over
        the microbatch).
    stage_params: P parameter trees (one per stage; tensors on any
        device — the engine ships CPU copies).
    tx: an optimizer factory applied per-stage to local grads.
    device: where every stage runs (None = the CUDA card).
    """

    def __init__(self, stage_fns: Sequence[Callable],
                 stage_params: Sequence[Any],
                 tx=None,
                 resources_per_stage: Optional[dict] = None,
                 tied: Sequence[tuple] = (),
                 device: Optional[str] = None):
        from .pipeline_cgraph import _host

        # tied: [(stage_i, key_i, stage_j, key_j), ...] — parameter pairs
        # that are copies of one weight (e.g. tied embedding/LM head split
        # across first/last stage). Their grads are exchanged and summed
        # before each optimizer step, so the copies evolve identically —
        # the Megatron-style tied-embedding all-reduce.
        self.tied = list(tied)
        self.num_stages = len(stage_fns)
        res = dict(resources_per_stage or {"CPU": 1.0})
        self._pg = placement_group([dict(res) for _ in range(self.num_stages)],
                                   strategy="SPREAD")
        if not self._pg.ready(timeout=60):
            raise TimeoutError("pipeline placement group not ready")
        actor_cls = ray_tpu_torch.remote(_StageActor)
        tx_blob = cloudpickle.dumps(tx) if tx is not None else None
        device = None if device is None else str(device)
        self.stages = []
        setups = []
        for i, (fn, params) in enumerate(zip(stage_fns, stage_params)):
            a = actor_cls.options(
                num_cpus=res.get("CPU", 1.0),
                placement_group=self._pg,
                placement_group_bundle_index=i).remote()
            self.stages.append(a)
            setups.append(a.setup.remote(i, self.num_stages,
                                         cloudpickle.dumps(fn),
                                         _host(params), tx_blob, device))
        ray_tpu_torch.get(setups, timeout=120)

    def step(self, microbatches: Sequence[Any], targets: Sequence[Any],
             apply: bool = True, timeout: float = 300.0) -> float:
        """One 1F1B training step over M microbatches. Returns mean loss."""
        from .pipeline_cgraph import _host

        P_, M = self.num_stages, len(microbatches)
        sizes = {len(mb) for mb in microbatches}
        if len(sizes) > 1:
            # per-microbatch mean losses are averaged and grads scaled by
            # 1/M — ragged sizes would silently mis-weight tokens
            raise ValueError(f"microbatches must be equal-sized, got {sizes}")
        microbatches = [_host(mb) for mb in microbatches]
        targets = [_host(t) for t in targets]
        sched = schedule_1f1b(P_, M)
        fwd_ref: List[List[Any]] = [[None] * M for _ in range(P_)]
        bwd_ref: List[List[Any]] = [[None] * M for _ in range(P_)]
        # submit ops per stage IN SCHEDULE ORDER (actor queues preserve
        # it); an op whose upstream ref isn't created yet is deferred to a
        # later sweep — the worklist drains in <= P sweeps
        pending = [list(ops) for ops in sched]
        while any(pending):
            progressed = False
            for i in range(P_):
                while pending[i]:
                    kind, mb = pending[i][0]
                    if kind == "fwd":
                        src = microbatches[mb] if i == 0 else fwd_ref[i - 1][mb]
                        if src is None:
                            break
                        if i == P_ - 1:
                            fwd_ref[i][mb] = self.stages[i].forward.remote(
                                mb, src, targets[mb])
                        else:
                            fwd_ref[i][mb] = self.stages[i].forward.remote(
                                mb, src)
                    else:
                        if fwd_ref[i][mb] is None:
                            break
                        g = None if i == P_ - 1 else bwd_ref[i + 1][mb]
                        if i != P_ - 1 and g is None:
                            break
                        bwd_ref[i][mb] = self.stages[i].backward.remote(mb, g)
                    pending[i].pop(0)
                    progressed = True
            if not progressed:
                raise RuntimeError("1F1B schedule deadlocked (bug)")
        losses = ray_tpu_torch.get([fwd_ref[P_ - 1][mb] for mb in range(M)],
                                   timeout=timeout)
        # wait for every stage's final backward so the step is fully
        # drained when this returns (per-actor FIFO ordering would already
        # sequence get_grad/apply_grads correctly, but callers of
        # step(apply=False) may read params/timings immediately after)
        ray_tpu_torch.get([bwd_ref[i][M - 1] for i in range(P_)],
                          timeout=timeout)
        if apply:
            # tied copies exchange grads ONCE per optimizer step, over the
            # full accumulation — doing it per step() would double-count
            # the partner's contribution under apply=False accumulation
            for (i, ki, j, kj) in self.tied:
                gi = self.stages[i].get_grad.remote(ki)
                gj = self.stages[j].get_grad.remote(kj)
                ray_tpu_torch.get([self.stages[i].add_grad.remote(ki, gj),
                                   self.stages[j].add_grad.remote(kj, gi)],
                                  timeout=timeout)
            ray_tpu_torch.get(
                [s.apply_grads.remote(1.0 / M) for s in self.stages],
                timeout=timeout)
        return float(sum(float(l) for l in losses) / M)

    def get_params(self) -> List[Any]:
        return ray_tpu_torch.get([s.get_params.remote() for s in self.stages],
                                 timeout=120)

    def shutdown(self) -> None:
        for s in self.stages:
            try:
                ray_tpu_torch.kill(s)
            except Exception:
                pass
        try:
            remove_placement_group(self._pg)
        except Exception:
            pass


def gpt_pipeline_stages(model, params, num_stages: int):
    """Split a GPT into pipeline stages. The split logic lives with the
    model (models/gpt.py gpt_pipeline_stages — chunk-count aware so the
    same entry point feeds the interleaved compiled engine); this
    wrapper keeps the reference's import path."""
    from ..models.gpt import gpt_pipeline_stages as _split

    return _split(model, params, num_stages)
