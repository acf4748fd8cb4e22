"""Failure detection + deterministic restart for prove jobs.

Counterpart of zigz_tpu/parallel/recovery.py: the supervisor and the
journal are carried over; the worker proves with the port's ``Prover`` on
the spec's ``device`` (``ProveJobSpec.device``, default ``"cuda"``), and
its heartbeat starts before ``torch`` is imported.

The reference has no failure story (SURVEY.md §5: single process, clean
halt on invalid instruction).  A multi-host prover needs one, and
the policy documented in :mod:`multihost` — fail-fast + deterministic
restart, exploiting that proof generation is a pure function of
(program, input, seed) — is mechanized here:

* the **worker** (:func:`run_worker`, also the module's ``__main__``)
  proves inside a subprocess, emits a heartbeat file at a fixed
  interval, and writes the serialized proof atomically
  (``proof.bin.tmp`` → rename) together with a digest journal entry;
* the **supervisor** (:class:`JobSupervisor`) launches the worker,
  detects failure three ways — process death, stale heartbeat
  (machine/host loss), wall-clock deadline (hang) — kills the exact
  PID it spawned, and relaunches with the identical spec;
* **determinism is enforced, not assumed**: every completed attempt
  appends ``sha256(proof_bytes)`` to the job journal, and a completed
  restart must reproduce the digest of any earlier completed run of
  the same spec (the reference's transcript-determinism test 5,
  integration_tests.zig:212, promoted to a recovery invariant).

Fault injection for tests mirrors the reference's proof-tampering
style (integration_tests.zig tests 6-8): a spec may carry
``fault = "crash_once" | "hang_once"``, which the worker honors only
on its first attempt (a sentinel file marks attempts), so the test
exercises the real detection/restart machinery end to end.

In a ``torch.distributed`` job a lost rank fails the whole job
(parallel/launch.py kills the survivors by PID) and the job is launched
again; the digest journal guarantees the rerun is the same proof.  The
single process under a supervisor is the testable core of that story.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["ProveJobSpec", "JobSupervisor", "JobFailed", "run_worker"]

HEARTBEAT_INTERVAL_S = 0.2


class JobFailed(Exception):
    """All restart attempts exhausted (or determinism violated)."""


@dataclass
class ProveJobSpec:
    """Everything that determines the proof bytes, plus job knobs."""

    program: bytes
    entry_pc: int = 0x1000
    initial_regs: Optional[List[int]] = None
    max_steps: int = 1 << 20
    input_tape: Optional[List[int]] = None
    seed: int = 0
    protocol_version: int = 1
    device: str = "cuda"  # where the worker proves: "cuda", "cuda:N" or "cpu"
    fault: Optional[str] = None  # test hook: "crash_once" | "hang_once"

    def to_json(self) -> str:
        d = dict(self.__dict__)
        d["program"] = self.program.hex()
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "ProveJobSpec":
        d = json.loads(s)
        d["program"] = bytes.fromhex(d["program"])
        return cls(**d)


def _paths(job_dir: str):
    return {
        "spec": os.path.join(job_dir, "spec.json"),
        "heartbeat": os.path.join(job_dir, "heartbeat"),
        "out": os.path.join(job_dir, "proof.bin"),
        "journal": os.path.join(job_dir, "journal.jsonl"),
        "attempt": os.path.join(job_dir, "attempt"),
    }


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------

def _start_heartbeat(path: str):
    """Daemon thread touching the heartbeat file; a SIGKILL'd or wedged
    interpreter stops touching it, which is exactly the signal the
    supervisor watches for."""
    import threading

    stop = threading.Event()

    def beat():
        while not stop.is_set():
            with open(path, "w") as f:
                f.write(str(time.time()))
            stop.wait(HEARTBEAT_INTERVAL_S)

    t = threading.Thread(target=beat, daemon=True)
    t.start()
    return stop


def _bump_attempt(path: str) -> int:
    n = 0
    if os.path.exists(path):
        with open(path) as f:
            n = int(f.read() or 0)
    with open(path, "w") as f:
        f.write(str(n + 1))
    return n + 1


def run_worker(job_dir: str) -> None:
    """Prove per the job spec; atomic output + digest journal entry."""
    import hashlib

    p = _paths(job_dir)
    with open(p["spec"]) as f:
        spec = ProveJobSpec.from_json(f.read())
    attempt = _bump_attempt(p["attempt"])

    if spec.fault == "crash_once" and attempt == 1:
        # Simulated host loss: no cleanup, no exit handlers.
        os.kill(os.getpid(), signal.SIGKILL)

    stop = _start_heartbeat(p["heartbeat"])
    if spec.fault == "hang_once" and attempt == 1:
        # Simulated machine freeze: SIGSTOP halts every thread, so the
        # heartbeat goes stale — the exact signal staleness detection
        # exists for.  (Guarantee one beat first so the supervisor's
        # staleness branch, not its startup-grace branch, fires.)
        time.sleep(2 * HEARTBEAT_INTERVAL_S)
        os.kill(os.getpid(), signal.SIGSTOP)
    try:
        # Absolute imports, deferred until the heartbeat is live: the
        # worker is launched by file path so its startup-to-first-beat
        # is milliseconds, not a package (torch) import.
        from zigz_tpu_torch.core.field import BabyBear
        from zigz_tpu_torch.prover.prover import Prover
        from zigz_tpu_torch.prover.serialization import BinarySerializer

        prover = Prover(
            BabyBear, seed=spec.seed, protocol_version=spec.protocol_version,
            device=spec.device,
        )
        proof = prover.prove(
            spec.program, spec.entry_pc, spec.initial_regs, spec.max_steps,
            None, spec.input_tape,
        )
        ser = BinarySerializer(BabyBear)
        tmp = p["out"] + ".tmp"
        h = hashlib.sha256()

        class _Tee:
            def __init__(self, f):
                self.f = f

            def write(self, b):
                h.update(b)
                self.f.write(b)

        with open(tmp, "wb") as f:
            size = ser.serialize_to(proof, _Tee(f))
        os.replace(tmp, p["out"])  # atomic: no partial proof is visible
        with open(p["journal"], "a") as f:
            f.write(json.dumps({
                "attempt": attempt,
                "sha256": h.hexdigest(),
                "bytes": size,
                "num_steps": proof.metadata.num_steps,
                "timings": {k: (round(v, 4) if isinstance(v, float) else v)
                            for k, v in prover.last_timings.items()},
            }) + "\n")
    finally:
        stop.set()


# ---------------------------------------------------------------------------
# Supervisor side
# ---------------------------------------------------------------------------

@dataclass
class JobResult:
    proof_path: str
    sha256: str
    attempts: int
    restarts: int
    journal: List[dict] = field(default_factory=list)


class JobSupervisor:
    """Fail-fast supervisor: launch, watch, kill-by-PID, restart."""

    def __init__(self, job_dir: str, heartbeat_timeout_s: float = 5.0,
                 deadline_s: float = 3600.0, max_restarts: int = 2,
                 startup_grace_s: float = 60.0):
        self.job_dir = job_dir
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.deadline_s = deadline_s
        self.max_restarts = max_restarts
        # Interpreter startup dominates time-to-first-beat; give it its
        # own, larger window than steady-state staleness.
        self.startup_grace_s = startup_grace_s
        self.restarts = 0

    def run(self, spec: ProveJobSpec) -> JobResult:
        os.makedirs(self.job_dir, exist_ok=True)
        p = _paths(self.job_dir)
        with open(p["spec"], "w") as f:
            f.write(spec.to_json())

        for attempt in range(self.max_restarts + 1):
            ok, why = self._run_once(p)
            if ok:
                entries = []
                with open(p["journal"]) as f:
                    for line in f:
                        entries.append(json.loads(line))
                digests = {e["sha256"] for e in entries}
                if len(digests) != 1:
                    # A restart produced different proof bytes: the purity
                    # invariant is broken — surface loudly, never silently
                    # accept either proof.
                    raise JobFailed(f"nondeterministic restart: digests {digests}")
                return JobResult(
                    proof_path=p["out"], sha256=entries[-1]["sha256"],
                    attempts=len(entries), restarts=self.restarts,
                    journal=entries,
                )
            self.restarts += 1
        raise JobFailed(f"gave up after {self.max_restarts + 1} attempts ({why})")

    def _run_once(self, p) -> tuple:
        env = dict(os.environ)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        if os.path.exists(p["heartbeat"]):
            os.unlink(p["heartbeat"])
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self.job_dir],
            env=env,
        )
        start = time.monotonic()
        try:
            while True:
                rc = proc.poll()
                if rc is not None:
                    if rc == 0 and os.path.exists(p["out"]):
                        return True, "ok"
                    return False, f"worker exited rc={rc}"
                now = time.monotonic()
                if now - start > self.deadline_s:
                    proc.kill()  # exact PID we spawned — never a pattern
                    proc.wait()
                    return False, "deadline exceeded"
                if os.path.exists(p["heartbeat"]):
                    age = time.time() - os.path.getmtime(p["heartbeat"])
                    if age > self.heartbeat_timeout_s:
                        proc.kill()
                        proc.wait()
                        return False, f"heartbeat stale ({age:.1f}s)"
                elif now - start > self.startup_grace_s:
                    # Never heartbeated at all (wedged in startup).
                    proc.kill()
                    proc.wait()
                    return False, "no heartbeat"
                time.sleep(0.05)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


if __name__ == "__main__":
    run_worker(sys.argv[1])
