"""Job submission — run entrypoint commands on a live cluster.

Equivalent of the reference's job-submission plane (ref:
dashboard/modules/job/job_manager.py:516 JobManager, :140 JobSupervisor
— a detached per-job supervisor actor runs the entrypoint shell command
and the job table survives the submitting client). With the
single-controller design this is THE path for "cluster outlives the
driver" workflows: external clients submit over the head's TCP port
(see cli.py `submit`) and the supervisor actor + job KV records live on
the head.

Job state machine: PENDING -> RUNNING -> SUCCEEDED | FAILED | STOPPED.
"""
from __future__ import annotations

import json
import time
import uuid
from typing import Dict, List, Optional

import ray_tpu_torch

_NS = "job"  # KV namespace for job records


def _kv():
    from .core import runtime as runtime_mod

    rt = runtime_mod.get_runtime()
    if hasattr(rt, "gcs"):  # head/driver process
        return (lambda k, v: rt.gcs.kv_put(k, v, namespace=_NS),
                lambda k: rt.gcs.kv_get(k, namespace=_NS),
                lambda p: rt.gcs.kv_keys(p, namespace=_NS))
    return (lambda k, v: rt.kv_put(k, v, namespace=_NS),
            lambda k: rt.kv_get(k, namespace=_NS),
            lambda p: rt.kv_keys(p, namespace=_NS))


def _record(job_id: str, **fields) -> Dict:
    put, get, _ = _kv()
    raw = get(job_id)
    rec = json.loads(raw.decode()) if raw else {}
    rec.update(fields)
    put(job_id, json.dumps(rec).encode())
    return rec


class JobSupervisor:
    """Detached actor owning one job's subprocess (ref: job_manager.py:140
    JobSupervisor.run — the entrypoint is a shell command; stdout/stderr
    are captured and the exit code decides SUCCEEDED/FAILED)."""

    def __init__(self, job_id: str, entrypoint: str,
                 env: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None):
        self._job_id = job_id
        self._entrypoint = entrypoint
        self._env = env or {}
        self._cwd = working_dir
        self._proc = None
        self._stop_requested = False
        _record(job_id, status="PENDING", entrypoint=entrypoint,
                submitted_at=time.time())

    def _self_destruct(self) -> None:
        """The supervisor exits once its job is terminal — detached actors
        are never GC'd, and a leaked 0.1-CPU actor per submitted job would
        starve a long-lived head. Delayed so run() returns cleanly first;
        the actor id must be captured NOW (the task context is gone by the
        time the timer fires)."""
        import threading

        try:
            actor_id = ray_tpu_torch.get_runtime_context().actor_id
        except Exception:
            return
        if actor_id is None:
            return

        def _kill():
            try:
                from .core import runtime as runtime_mod

                runtime_mod.get_runtime().kill_actor(actor_id,
                                                     no_restart=True)
            except Exception:
                pass

        threading.Timer(0.5, _kill).start()

    def run(self) -> int:
        import os
        import subprocess

        if self._stop_requested:  # stopped while PENDING
            _record(self._job_id, status="STOPPED",
                    finished_at=time.time(), exit_code=-15, logs="")
            self._self_destruct()
            return -15
        env = dict(os.environ)
        env.update({str(k): str(v) for k, v in self._env.items()})
        env["RTPU_JOB_ID"] = self._job_id
        _record(self._job_id, status="RUNNING", started_at=time.time())
        try:
            # own process group: stop() must reach the shell's CHILDREN,
            # not just the /bin/sh wrapper (ref: job_manager.py:140 kills
            # the supervisor's whole process tree)
            self._proc = subprocess.Popen(
                self._entrypoint, shell=True, env=env, cwd=self._cwd,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, start_new_session=True)
            if self._stop_requested:
                # stop() ran in the other concurrency lane between the
                # PENDING check above and the Popen assignment — it saw
                # _proc None and could only set the flag; honor it now
                import signal

                try:
                    os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
                except Exception:
                    self._proc.terminate()
            out, _ = self._proc.communicate()
            rc = self._proc.returncode
        except Exception as e:  # spawn failure is a FAILED job, not a crash
            _record(self._job_id, status="FAILED", finished_at=time.time(),
                    exit_code=-1, logs=f"entrypoint failed to start: {e}")
            self._self_destruct()
            return -1
        _record(self._job_id,
                status=("SUCCEEDED" if rc == 0 else
                        "STOPPED" if rc < 0 else "FAILED"),
                finished_at=time.time(), exit_code=rc, logs=out or "")
        self._self_destruct()
        return rc

    def stop(self) -> bool:
        import os
        import signal

        if self._proc is None:
            # not launched yet: flag it so run() records STOPPED instead
            # of executing (the reference moves PENDING straight to STOPPED)
            self._stop_requested = True
            return True
        if self._proc.poll() is None:
            try:
                os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
            except Exception:
                self._proc.terminate()
            return True
        return False

    def ping(self) -> bool:
        return True


def submit_job(entrypoint: str, *, env: Optional[Dict[str, str]] = None,
               working_dir: Optional[str] = None,
               job_id: Optional[str] = None) -> str:
    """-> job_id. The supervisor is detached: it outlives the submitter
    (ref: job_manager.py:516 submit_job)."""
    job_id = job_id or f"job-{uuid.uuid4().hex[:8]}"
    sup = ray_tpu_torch.remote(JobSupervisor).options(
        name=f"_rtpu_job:{job_id}", lifetime="detached",
        num_cpus=0.1,
        # run() blocks for the whole job: stop()/ping() need their own lane
        max_concurrency=2).remote(job_id, entrypoint, env, working_dir)
    # fire-and-forget: the run() result lands in the job KV record
    sup.run.remote()
    return job_id


def get_job_status(job_id: str) -> Optional[str]:
    rec = get_job_info(job_id)
    return None if rec is None else rec.get("status")


def get_job_info(job_id: str) -> Optional[Dict]:
    _, get, _ = _kv()
    raw = get(job_id)
    return None if raw is None else json.loads(raw.decode())


def get_job_logs(job_id: str) -> str:
    rec = get_job_info(job_id) or {}
    return rec.get("logs", "")


def list_jobs() -> List[Dict]:
    _, get, keys = _kv()
    out = []
    for k in keys(""):
        raw = get(k)
        if raw:
            rec = json.loads(raw.decode())
            rec["job_id"] = k
            out.append(rec)
    return out


def stop_job(job_id: str) -> bool:
    try:
        sup = ray_tpu_torch.get_actor(f"_rtpu_job:{job_id}")
        return ray_tpu_torch.get(sup.stop.remote(), timeout=30)
    except Exception:
        return False


def wait_job(job_id: str, timeout: float = 300.0,
             poll_s: float = 0.25) -> Dict:
    """Block until the job reaches a terminal state; -> final record."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rec = get_job_info(job_id)
        if rec and rec.get("status") in ("SUCCEEDED", "FAILED", "STOPPED"):
            return rec
        time.sleep(poll_s)
    raise TimeoutError(f"job {job_id} still "
                       f"{(get_job_info(job_id) or {}).get('status')} "
                       f"after {timeout}s")
