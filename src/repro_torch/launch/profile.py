"""Measured profiling on the card (paper §3.3): per-layer ``(tf, tb)`` sweeps.

    PYTHONPATH=src python -m repro_torch.launch.profile --seq 256 \\
        --batches 1,2,4,8 --replicate 4 --mem-gb 20 -o prof.json   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --plan --profile prof.json \\
        --devices 4 --global-batch 8 --n-micro 4 --compress int8
    PYTHONPATH=src python -m repro_torch.launch.profile --smoke --device cpu \\
        --replicate 4 -o prof.json                                  # CPU rehearsal

The port of ``repro.launch.profile``: it times the model's layer functions
(``core.profiler.measure_layer_times`` over :func:`build_layer_fns`) across
a batch-size sweep and writes the same versioned ``asteroid-profile`` JSON
artifact, which ``launch.train --plan --profile`` plans on.  Only the
embedding, one period and the head are built: block layers of the same
kind reuse period 0's weights, since the time does not depend on the
values.  ``--replicate N`` tiles the card's row into N virtual devices,
the devices a one-card ``--devices N`` pipeline plans over; give each its
share of the card with ``--mem-gb`` (80 GB / N on an H100 80 GB).  The
default budget is the whole card's memory.

One process profiles one device: the multi-process gather of ``repro``
(one row per JAX process) comes with real multi-card meshes, a later slice
of the port.  Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch


def build_layer_fns(cfg, seq_len: int, seed: int = 0, device="cuda", params=None):
    """Per-layer callables matching ``LayerTable.from_model_config(cfg)``.

    Returns ``(layer_fns, make_input)`` for ``measure_layer_times``: one
    ``x -> y`` per table entry (embed, each of the ``n_layers`` block
    layers, head).  ``params`` is a model tree (stacked periods; only
    period 0 is read); by default the embedding, one period and the head
    are initialised from ``seed`` on ``device``.
    """
    from repro_torch.models.blocks import apply_layer, init_period, tree_index
    from repro_torch.models.model import _head_weight, embed_tokens
    from repro_torch.models.module import dense_init, embed_init

    device = torch.device(device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        d, v, dtype = cfg.d_model, cfg.vocab_size, cfg.pdtype
        params = {"embed": embed_init(gen, (v, d), dtype, device),
                  "periods": init_period(gen, cfg, device, lead=(1,))}
        if not cfg.tie_embeddings:
            params["head"] = dense_init(gen, (d, v), d, dtype, device)
    period0 = tree_index(params["periods"], 0)

    def embed_fn(tokens):
        return embed_tokens(params, tokens, cfg)

    fns = [embed_fn]
    for li in range(cfg.n_layers):
        spec = cfg.pattern[li % len(cfg.pattern)]
        lp = period0["layers"][li % len(cfg.pattern)]

        def block_fn(x, lp=lp, spec=spec):
            B, S = x.shape[0], x.shape[1]
            positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
            return apply_layer(lp, x, positions, cfg, spec)

        fns.append(block_fn)

    head_w = _head_weight(params, cfg)

    def head_fn(x):
        return x @ head_w

    fns.append(head_fn)

    def make_input(beta: int, li: int):
        if li == 0:            # embed consumes token ids
            return torch.zeros((beta, seq_len), dtype=torch.long, device=device)
        return torch.full((beta, seq_len, cfg.d_model), 0.01, dtype=cfg.cdtype,
                          device=device)

    return fns, make_input


def _card_mem_bytes(device: torch.device) -> float:
    """The planner's budget u_d for one device: the card's memory (the
    counterpart of the host memory ``repro`` reads), or the host's on the
    CPU."""
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    try:
        return float(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):
        return 8e9


def measure_model(cfg, seq_len: int, batch_sizes=(1, 2, 4), repeats: int = 3,
                  *, replicate: int = 1, mem_bytes: float | None = None,
                  bandwidth: float | None = None, seed: int = 0, device="cuda"):
    """Profile ``cfg`` on ``device`` into a ``MeasuredProfile``.

    Runs the per-layer sweep, then tiles the row ``replicate`` times into
    virtual devices.  The effective FLOP rate at the largest measured batch
    is recorded per device, so ``MeasuredProfile.cluster()`` yields the
    best analytic model of the same hardware.
    """
    import numpy as np

    from repro_torch.core.hardware import MBPS_1000
    from repro_torch.core.profiler import (LayerTable, MeasuredProfile, config_fingerprint,
                                           device_fingerprint, measure_layer_times)

    device = torch.device(device)
    table = LayerTable.from_model_config(cfg, seq_len)
    fns, make_input = build_layer_fns(cfg, seq_len, seed, device)
    assert len(fns) == table.L, (len(fns), table.L)
    batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
    t0 = time.perf_counter()
    tf, tb = measure_layer_times(fns, make_input, batch_sizes, repeats)
    elapsed = time.perf_counter() - t0
    tf, tb = tf[None], tb[None]                      # (D, n_batches, L)
    beta_max = batch_sizes[-1]
    est = float(table.flops(0, table.L) * beta_max / max(tf[0, -1].sum(), 1e-12))
    mem = mem_bytes if mem_bytes is not None else _card_mem_bytes(device)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    one = MeasuredProfile(
        arch=cfg.name, seq_len=seq_len, batch_sizes=batch_sizes,
        layer_names=tuple(l.name for l in table.layers),
        tf=tf, tb=tb, device_names=(f"{device.type}:0",),
        config_hash=config_fingerprint(cfg, seq_len),
        device_hash=device_fingerprint(device),
        mem_bytes=(float(mem),), est_flops=(est,),
        bandwidth=float(bandwidth if bandwidth is not None else MBPS_1000),
        repeats=repeats,
        meta={"torch": torch.__version__,
              "python": sys.version.split()[0],
              "platform": device.type,
              "device_kind": card,
              "measure_seconds": round(elapsed, 3),
              "created": time.strftime("%Y-%m-%dT%H:%M:%S%z")})
    return retile(one, replicate) if replicate > 1 else one


def retile(mp, replicate: int, mem_bytes: float | None = None):
    """``mp``'s first device row tiled into ``replicate`` virtual devices
    (``--replicate``), each with ``mem_bytes`` of memory (default: the
    row's own).  No layer is timed again: a measured artifact serves a
    virtual cluster of another size or memory split of the same card."""
    import numpy as np

    mem = float(mp.mem_bytes[0] if mem_bytes is None else mem_bytes)
    base = mp.device_names[0].split("/v")[0]
    return dataclasses.replace(
        mp, tf=np.tile(mp.tf[:1], (replicate, 1, 1)), tb=np.tile(mp.tb[:1], (replicate, 1, 1)),
        device_names=tuple(f"{base}/v{k}" for k in range(replicate)),
        mem_bytes=(mem,) * replicate, est_flops=(mp.est_flops[0],) * replicate)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.profile",
        description="measure per-layer (tf, tb) sweeps on the card and write "
                    "a planner-consumable profile artifact")
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="profile the reduced same-family config")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized run: --smoke, seq 64, batches 1,2,4, "
                         "1 repeat, 4 virtual devices")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 128; 64 under --quick)")
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch sizes to sweep "
                         "(default 1,2,4,8; 1,2,4 under --quick)")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timed repetitions per (layer, batch) after the "
                         "warm-up (default 3; 1 under --quick)")
    ap.add_argument("--replicate", type=int, default=None,
                    help="tile the card's row into N virtual devices "
                         "(default 1; 4 under --quick)")
    ap.add_argument("--mem-gb", type=float, default=None,
                    help="per-device memory budget (default: the card's memory)")
    ap.add_argument("--bw-mbps", type=float, default=None,
                    help="assumed D2D bandwidth between profiled devices "
                         "(default 1000)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    ap.add_argument("-o", "--out", default="prof.json")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card found: the port profiles the card; "
                         "pass --device cpu to profile the plain versions on the CPU")
    seq = args.seq if args.seq is not None else (64 if args.quick else 128)
    batches = tuple(int(b) for b in args.batches.split(",")) if args.batches \
        else ((1, 2, 4) if args.quick else (1, 2, 4, 8))
    repeats = args.repeats if args.repeats is not None else (1 if args.quick else 3)
    replicate = args.replicate if args.replicate is not None else \
        (4 if args.quick else 1)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.profiler import save_profile

    smoke = args.smoke or args.quick
    cfg = get_smoke_config(args.arch) if smoke else get_config(args.arch)
    print(f"profiling {cfg.name} (smoke={smoke}) seq={seq} "
          f"batches={batches} repeats={repeats} replicate={replicate}")
    mp = measure_model(cfg, seq, batches, repeats, replicate=replicate,
                       mem_bytes=None if args.mem_gb is None else args.mem_gb * 1e9,
                       bandwidth=None if args.bw_mbps is None
                       else args.bw_mbps * 1e6 / 8, device=device)
    mp = dataclasses.replace(mp, meta={**mp.meta, "arch_id": args.arch, "smoke": smoke})
    for li, name in enumerate(mp.layer_names):
        fwd = " ".join(f"{mp.tf[0, bi, li] * 1e3:8.3f}"
                       for bi in range(len(mp.batch_sizes)))
        bwd = " ".join(f"{mp.tb[0, bi, li] * 1e3:8.3f}"
                       for bi in range(len(mp.batch_sizes)))
        print(f"  {name:>10s}  fwd[ms] {fwd}   bwd[ms] {bwd}")
    save_profile(args.out, mp)
    print(f"profile ({mp.D} device rows x {len(mp.batch_sizes)} batches x "
          f"{mp.L} layers) -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
