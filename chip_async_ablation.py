#!/usr/bin/env python3
"""Staleness 1 and double buffering against the synchronous step, in turns,
on one card.

    python3 chip_async_ablation.py [--steps 6] [--turns sync,stale,...]

Trains full-width ``phi3-mini-3.8b`` (32 layers, fp32) through the
launcher's uniform path at phase 6b's settings (``--stage 4 --n-micro 4
--global-batch 8 --seq 256 --compress int8 --bucket-mb 256
--no-error-feedback``) once per turn, in the order given, each turn's
state freed before the next (one training state is 61 GB).  The variants:

* ``sync``: the synchronous step;
* ``sync-db``: synchronous, boundary round trips on a second stream;
* ``stale``: staleness 1, double-buffered (its default);
* ``stale-nodb``: staleness 1, boundaries on the main stream.

Prints each turn's ms/step (host clock, after the launcher's warm-up
steps), peak memory, final loss, the caching allocator's retries and
cudaMalloc / cudaFree calls over the run, and the device busy time and
wall time of one more step under ``torch.profiler``, beside the card's
name and power limit, then a JSON line of the turns.  Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

VARIANTS = {"sync": [], "sync-db": ["--double-buffer"], "stale": ["--staleness", "1"],
            "stale-nodb": ["--staleness", "1", "--no-double-buffer"]}
BASE = ["--stage", "4", "--n-micro", "4", "--global-batch", "8", "--seq", "256",
        "--compress", "int8", "--bucket-mb", "256", "--no-error-feedback", "--log-every", "100"]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def traced_step(torch, res):
    """Device busy time (the sum of kernel times in a ``torch.profiler``
    trace) and wall time of one more step on the run's final state."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import SyntheticLM

    ts, params, opt_state = res["ts"], res["params"], res["opt_state"]
    ef = res["ef"]
    batch = ts.shard_batch(SyntheticLM(ts.spec.cfg.vocab_size, 256).batch(99, 8))

    def step(held):
        if ts.spec.staleness:
            return ts.async_step_fn(params, opt_state, held, ef, batch)[2]
        ts.step_fn(params, opt_state, ef, batch)
        return None

    held = step(None)                    # a full round follows a round that held one
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(held)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy, wall


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--turns", default="sync,stale,stale-nodb,sync-db,sync-db,stale-nodb,stale,sync")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_async_ablation: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launcher

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    _build.build_all()
    rows = []
    for name in args.turns.split(","):
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_stats(dev)
        res = launcher.main(BASE + VARIANTS[name] + ["--steps", str(args.steps)])
        stats = torch.cuda.memory_stats(dev)
        ms = res["seconds"] / res["timed_steps"] * 1e3
        busy, wall = traced_step(torch, res)
        row = {"turn": name, "ms_per_step": ms, "timed_steps": res["timed_steps"],
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "loss": res["losses"][-1], "traced_busy_ms": busy, "traced_wall_ms": wall,
               "card": card}
        for key in ("num_alloc_retries", "num_device_alloc", "num_device_free"):
            row[key] = stats.get(key, 0) - before.get(key, 0)
        print(f"turn {name}: {ms:.1f} ms/step over {res['timed_steps']} steps, peak "
              f"{row['peak_gb']:.3f} GB, loss {row['loss']:.6f}; allocator over the run: "
              f"{row['num_alloc_retries']} retries, {row['num_device_alloc']} cudaMalloc, "
              f"{row['num_device_free']} cudaFree; one more step traced: device busy "
              f"{busy:.1f} ms of {wall:.1f} ms wall; {card}")
        rows.append(row)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"turns": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
