#!/usr/bin/env python3
"""Probe of torch.distributed's two routes for ``sgg_torch.dist`` on a card.

  python -m torch.distributed.run --standalone --nproc_per_node 2 scripts/dist_probe.py gloo
  python -m torch.distributed.run --standalone --nproc_per_node 1 scripts/dist_probe.py nccl

``gloo``: every rank on ``cuda:0`` (ranks that share one card); ``nccl``:
rank r on ``cuda:r``. Each rank all-reduces (sum) a float32 CUDA bucket of
1 Ki, 1 Mi and 16 Mi elements, filled with rank + 1, and checks the sum;
then broadcasts a bucket from rank 0 and checks it; then, for gloo, the same
all-reduce staged through pinned host memory (copy down, reduce on the
host, copy up). Rank 0 prints the mean ms of each over 10 calls, after one
warm call, with the card's name and power limit. Exits non-zero if a check
fails or a collective raises.
"""

import os
import subprocess
import sys
import time
from datetime import timedelta

import torch
import torch.distributed as dist

SIZES = (1 << 10, 1 << 20, 1 << 24)
REPS = 10


def timed(fn, device):
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / REPS * 1e3


def main() -> int:
    backend = sys.argv[1]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device("cuda", 0 if backend == "gloo" else local)
    torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, timeout=timedelta(seconds=60), **kw)
    out = []
    for n in SIZES:
        x = torch.full((n,), float(rank + 1), device=device)
        want = float(world * (world + 1) // 2)

        def reduce_():
            x.fill_(float(rank + 1))
            dist.all_reduce(x)

        ms = timed(reduce_, device)
        ok = bool((x == want).all())
        b = torch.arange(n, device=device, dtype=torch.float32) * (1.0 if rank == 0 else 0.0)
        ms_b = timed(lambda: dist.broadcast(b, 0), device)
        ok_b = bool((b == torch.arange(n, device=device, dtype=torch.float32)).all())
        line = (f"{backend} world {world} bucket {n} float32 on {device}: all_reduce "
                f"{ms:.4f} ms ({'ok' if ok else 'WRONG'}), broadcast {ms_b:.4f} ms "
                f"({'ok' if ok_b else 'WRONG'})")
        if backend == "gloo":
            host = torch.empty(n, pin_memory=True)

            def staged():
                x.fill_(float(rank + 1))
                host.copy_(x)
                dist.all_reduce(host)
                x.copy_(host, non_blocking=True)

            ms_s = timed(staged, device)
            ok_s = bool((x == want).all())
            line += f", staged through pinned host {ms_s:.4f} ms ({'ok' if ok_s else 'WRONG'})"
        out.append((line, ok and ok_b))
    dist.barrier()
    if rank == 0:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"[dist_probe] torch {torch.__version__}, CUDA {torch.version.cuda}; "
              f"{smi.stdout.strip()}", flush=True)
        for line, _ in out:
            print(f"[dist_probe] {line}", flush=True)
    dist.destroy_process_group()
    return 0 if all(ok for _, ok in out) else 1


if __name__ == "__main__":
    sys.exit(main())
