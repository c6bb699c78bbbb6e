#!/usr/bin/env python3
"""The process group on several cards: one process per card over NCCL.

    python3 dist_cards.py [N]     # N cards, all visible ones by default (at least 2)

chip_smoke.py's process-group phases run on one card (one NCCL rank, two
gloo ranks taking turns on it). This script runs the same cells across
cards, each rank on the card of its LOCAL_RANK, and times what one card
cannot show:
1. the full-width fused G step (#6, #8) and the all-pairs R step (#1, #4)
   at dropout 0 on one card over all 64 rows: the reference, 3 timed steps
   after a warm-up;
2. N ranks, 64 / N rows each: each rank's loss within rtol 1e-5 of the
   one-card step and each gradient within GRAD_REL of its norm (the gap is
   printed), the ranks' parameters bitwise equal after 2 steps, then 3
   timed steps (s per step at 64 / N rows per card beside the one-card
   step) and the gradient all-reduce alone between the cards;
3. launch/train_r.main on the smoke config on N ranks through torchrun's
   environment (NCCL, "cuda" = the card of LOCAL_RANK), one epoch of its 16
   segments at 16 / N rows per rank (one global step) with a val pass:
   parameters bitwise equal, save/ on rank 0 alone.
Any failure exits non-zero. The last line is the cards' names and power
limits (nvidia-smi).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as C  # noqa: E402

CELLS = (("G", ("nn_signed", "dist_loss")), ("R", ("h2o_nn", "h2o_nn_dvec")))
# Each gradient against the one-card step's, relative to its norm. Looser
# than chip_smoke's two-rank 1e-5: the same G step summed over 4 slices of
# 2 rows in one process already moved a gradient by 1.5e-4 of its norm on
# the CPU (batched matmuls round differently at another batch size, which
# can move a row's nearest object point between two nearly equidistant
# ones; the gradient follows the point).
GRAD_REL = 1e-3


def _kernels(label: str) -> dict:
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    if label == "G":
        return {"nn_signed": CS.KERNEL, "dist_loss": CL.KERNEL}
    return {"h2o_nn": NN.KERNEL, "h2o_nn_dvec": NN.DVEC_KERNEL}


def _calls(dev, rows=slice(None)):
    """{label: (state, step call)} of chip_smoke's process-group cells on
    `dev`, on `rows` of their 64."""
    (g_state, g_step, gdb, noise), (r_state, r_step, rdb) = C._dist_cells(dev)
    gdb = {k: v[rows] for k, v in gdb.items()}
    rdb = {k: v[rows] for k, v in rdb.items()}
    noise = noise[rows]
    return {"G": (g_state, lambda: g_step(g_state, gdb, noise=noise)),
            "R": (r_state, lambda: r_step(r_state, rdb))}


def one_card() -> dict:
    """The one-card reference: first step's loss and gradients, then the
    mean of 3 timed steps."""
    import torch

    out = {}
    for label, (state, call) in _calls(torch.device("cuda", 0)).items():
        m = call()
        out[label] = dict(loss=float(m["loss"]), grads=C._grads(state), step_s=C._timed_steps(call)[0])
    torch.cuda.empty_cache()
    return out


def _step_worker(shared: str) -> None:
    """A rank of phase 2, started with torchrun's environment."""
    import torch

    from oakink2_tamf_tpu_torch.parallel import mesh

    rank, W = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = mesh.local_device("cuda")
    mesh.init_distributed(backend="nccl", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
                          world_size=W, rank=rank, device=dev)
    b = C.TRAIN_BS // W
    res = {}
    for label, (state, call) in _calls(dev, slice(rank * b, (rank + 1) * b)).items():
        kernels = _kernels(label)
        C._zero_counts(kernels)
        m = call()
        res[label] = dict(loss=float(m["loss"]), grads=C._grads(state))
        call()
        res[label]["launches"] = {n: k.launches for n, k in kernels.items()}
        res[label]["digest"] = C._params_digest(state)
        res[label]["step_s"], res[label]["steps_s"], _, res[label]["peak_gib"] = C._timed_steps(call)
        params = state.optimizer.params
        res[label]["allreduce_ms"] = C.cuda_time_ms(lambda: mesh.all_reduce_grads_(params), reps=10, warmup=2)
    torch.save(res, os.path.join(shared, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _train_r_worker(shared: str) -> None:
    """A rank of phase 3, started with torchrun's environment."""
    import torch

    from oakink2_tamf_tpu_torch.launch import train_r

    smoke = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "synthetic_smoke.yml")
    rows = str(16 // int(os.environ["WORLD_SIZE"]))  # the smoke config's 16 segments in one global step
    state = train_r.main(["--cfg", smoke, "--exp_id", "cards_r", "--train.num_epoch", "1", "--train.val_freq", "1",
                          "--train.eval_max_batches", "1", "--train.batch_size", rows, "--commit"])
    torch.save({"step": state.step, "digest": C._params_digest(state)},
               os.path.join(shared, f"train_r{torch.distributed.get_rank()}.pt"))
    torch.distributed.destroy_process_group()


def _spawn(mode: str, shared: str, W: int) -> list[str]:
    """W processes of this script in `mode`, torchrun's environment each,
    from shared/rank{r}; every one must exit 0 (chip_smoke._spawn_ranks'
    rules). -> their outputs."""
    import subprocess

    port = C._free_port()
    procs = []
    try:
        for r in range(W):
            cwd = os.path.join(shared, f"rank{r}")
            os.makedirs(cwd, exist_ok=True)
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(W), LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, shared], cwd=cwd, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs, deadline = [], time.perf_counter() + C.DIST_TIMEOUT_S
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
            except subprocess.TimeoutExpired:
                outs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        C.require(p.returncode == 0, f"rank {r} exited {p.returncode}:\n{o[-4000:]}")
    return outs


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("dist_cards: needs at least two CUDA cards", file=sys.stderr)
        return 1
    W = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    C.require(2 <= W <= torch.cuda.device_count() and C.TRAIN_BS % W == 0 and 16 % W == 0, f"{W} ranks")
    from oakink2_tamf_tpu_torch._device import set_fp32_precision
    from oakink2_tamf_tpu_torch.ops import _build

    set_fp32_precision()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {W} of {torch.cuda.device_count()} cards", flush=True)
    _build.build_all([k for label, _ in CELLS for k in _kernels(label).values()])
    one = one_card()
    summary = {"ranks": W}
    with tempfile.TemporaryDirectory(prefix="tamf_cards_") as shared:
        t0 = time.perf_counter()
        _spawn("--step-worker", shared, W)
        wall = time.perf_counter() - t0
        res = [torch.load(os.path.join(shared, f"rank{r}.pt"), weights_only=False) for r in range(W)]
    for label, names in CELLS:
        want = one[label]
        gaps = []
        for r in range(W):
            got = res[r][label]
            C.require(abs(got["loss"] - want["loss"]) <= C.DIST_REL * abs(want["loss"]),
                      f"{label} rank {r}: loss {got['loss']} vs one card's {want['loss']}")
            gap, name = C._grad_gap_rel(got["grads"], want["grads"])
            C.require(gap <= GRAD_REL, f"{label} rank {r}: gradient {name} {gap:.3e} of its norm from one card's")
            C.require(all(got["launches"][k] == 2 for k in names), f"{label} rank {r}: {got['launches']}")
            gaps.append(gap)
        C.require(len({res[r][label]["digest"] for r in range(W)}) == 1, f"{label}: the ranks' parameters differ")
        steps = [res[r][label]["step_s"] for r in range(W)]
        ar = [res[r][label]["allreduce_ms"] for r in range(W)]
        print(f"{W} cards (NCCL), {label} at full width, {C.TRAIN_BS // W} of {C.TRAIN_BS} rows per card: gradients "
              f"within {max(gaps):.2e} of one card's; parameters bitwise equal after 2 steps; step "
              f"{max(steps):.4f} s (slowest rank; one card on all {C.TRAIN_BS} rows {want['step_s']:.4f} s: "
              f"{want['step_s'] / max(steps):.2f}x); gradient all-reduce between the cards {min(ar):.4f}-{max(ar):.4f} "
              f"ms = {100 * max(ar) / (1e3 * max(steps)):.2f}% of the step; peak "
              f"{max(res[r][label]['peak_gib'] for r in range(W)):.2f} GiB per card", flush=True)
        summary[label] = dict(one_card_step_s=want["step_s"], step_s=steps, allreduce_ms=ar, grad_gap=max(gaps))
    print(f"{W} ranks: {wall:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="tamf_cards_r_") as shared:
        t0 = time.perf_counter()
        outs = _spawn("--train-r-worker", shared, W)
        wall = time.perf_counter() - t0
        res = [torch.load(os.path.join(shared, f"train_r{r}.pt"), weights_only=False) for r in range(W)]
        saved = [os.path.isdir(os.path.join(shared, f"rank{r}", "common", "train_r", "cards_r", "save"))
                 for r in range(W)]
    C.require(all(r["step"] == 1 for r in res), f"train_r.main: steps {[r['step'] for r in res]}")
    C.require(len({r["digest"] for r in res}) == 1, "train_r.main: the ranks' parameters differ")
    C.require(saved == [True] + [False] * (W - 1), f"train_r.main: save/ per rank {saved}")
    C.require("val epoch 0000 refine eval" in outs[0], "train_r.main: no eval line on rank 0")
    print(f"train_r.main on {W} cards (NCCL, torchrun environment): {wall:.1f} s; parameters bitwise equal after "
          f"{res[0]['step']} step(s); save/ on rank 0 alone", flush=True)
    cards = C.card_line().splitlines()
    summary["cards"] = cards
    print("dist_cards: " + json.dumps(summary), flush=True)
    print("; ".join(cards[:W]))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] in ("--step-worker", "--train-r-worker"):
        from oakink2_tamf_tpu_torch._device import set_fp32_precision

        set_fp32_precision()
        (_step_worker if sys.argv[1] == "--step-worker" else _train_r_worker)(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
