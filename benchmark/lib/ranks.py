"""Cells of several chips: one process per card, started from the one command.

The process the driver starts (the parent) picks a free port on localhost
and starts `chips` processes of benchmark/run.py with the same arguments
and `--rank r --world n --port p --handoff <dir> --t0 <its start>`. Each
rank joins a torch.distributed process group at tcp://localhost:<port>
(NCCL on the cards), runs the cell on card r and writes its result and its
lines for standard error to <dir>/rank<r>.json; no tensor passes between
the processes outside the process group. <dir> is a fresh directory under
TMPDIR, removed afterwards. The parent waits for every rank, ends them all
if one fails, and merges their results (`merge`).
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

RANK_TIMEOUT_S = 1500.0  # a first run in a checkout compiles


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(run_py: str, argv: list[str], world: int, t0: float, rank_device: str = "cuda") -> list[dict]:
    """Runs the ranks and returns what each wrote ({"result", "lines"}), in
    rank order; raises RuntimeError naming the rank where one fails."""
    handoff = tempfile.mkdtemp(prefix="bench-ranks-")
    port = free_port()
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, run_py, *argv, "--rank", str(r), "--world", str(world), "--port", str(port),
                   "--handoff", handoff, "--t0", repr(t0), "--rank-device", rank_device]
            procs.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL))
        failed = _wait(procs)
        if failed:
            raise RuntimeError(f"rank(s) {failed} of {world} failed")
        out = []
        for r in range(world):
            with open(os.path.join(handoff, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(handoff, ignore_errors=True)


def _wait(procs) -> list[int]:
    """Waits for every rank; once one exits with an error, or RANK_TIMEOUT_S
    has passed, the others are ended. Returns the ranks that failed."""
    failed = []
    pending = dict(enumerate(procs))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    while pending:
        if time.monotonic() > deadline:
            for r, p in pending.items():
                p.kill()
                p.wait()
                failed.append(r)
            break
        for r, p in list(pending.items()):
            try:
                rc = p.wait(timeout=0.5)
            except subprocess.TimeoutExpired:
                continue
            del pending[r]
            if rc != 0:
                failed.append(r)
                for q in pending.values():
                    q.terminate()
    return sorted(failed)


def write(handoff: str, rank: int, result: dict, lines: list[str]) -> None:
    path = os.path.join(handoff, f"rank{rank}.json")
    with open(path + ".part", "w") as f:
        json.dump({"result": result, "lines": lines}, f)
    os.replace(path + ".part", path)


def merge(results: list[dict]) -> dict:
    """One result from the ranks': rank 0's metrics, counts and breakdown (an
    entry of several chips reports the whole group's work on every rank),
    `correct` only where every rank is, each compared number at its worst
    rank, the peak of the fullest card, the busy time averaged over the
    cards."""
    r0 = results[0]
    checks = {}
    for r in results:
        for name, c in r["checks"].items():
            if name not in checks or c["value"] > checks[name]["value"]:
                checks[name] = c
    device = dict(r0["device"], count=len(results),
                  memory_peak_bytes=max(r["device"]["memory_peak_bytes"] for r in results))
    if "busy_s" in device:
        device["busy_s"] = statistics.fmean(r["device"]["busy_s"] for r in results)
    out = {"correct": all(r["correct"] for r in results), "attempted": r0["attempted"], "failed": r0["failed"],
           "metrics": r0["metrics"], "device": device}
    if "breakdown" in r0:
        out["breakdown"] = r0["breakdown"]
    out["checks"] = checks
    return out
