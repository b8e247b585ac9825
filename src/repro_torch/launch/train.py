"""Training launcher: the virtual-stage pipeline on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --stage 4 --n-micro 4 --global-batch 8 --seq 256 --steps 4 \\
        --compress int8 --bucket-mb 256 --no-error-feedback       # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --stage 2 --steps 2 --compress int8

The non-``--plan`` path of ``repro.launch.train``: ``build_train_step`` with
``--stage`` virtual stages and ``--n-micro`` micro-batches, AdamW on a cosine
schedule, ``SyntheticLM`` batches (bit-identical to ``repro``'s), the
compressed wire with ``--compress``.  It prints the same ``plan:``,
``step ... loss ... ce ... tok/s ...`` and ``FINAL tok_s=... loss=...`` lines.
Weights are random from seed 0 (``torch.Generator`` draws, not JAX's).
Runs on ``cuda`` unless ``--device cpu`` is given; without a card it stops
rather than running on the CPU.

Not ported yet, and refused: ``--plan`` (with ``--profile``,
``--portfolio``, ``--events``/``--fail-at`` and ``--compress auto``),
``--staleness 1`` and ``--double-buffer``, ``--checkpoint-dir``, and the
multi-device ``--devices``/``--data-axis``.
"""

from __future__ import annotations

import argparse
import time

import torch

#: flags of ``repro.launch.train`` that need a later slice of the port
_LATER = {
    "plan": "--plan needs the planner and lowering, the next slice of the port",
    "profile": "--profile feeds the planner (--plan), the next slice of the port",
    "portfolio": "--portfolio probes planner Plans (--plan), a later slice of the port",
    "events": "--events/--fail-at need PipelineSession (membership), a later slice of the port",
    "fail_at": "--events/--fail-at need PipelineSession (membership), a later slice of the port",
    "double_buffer": "--double-buffer (overlapped sends) is a later slice of the port",
    "checkpoint_dir": "--checkpoint-dir needs checkpoint/, a later slice of the port",
    "devices": "--devices/--data-axis: the port trains on one card; "
               "multi-card meshes are a later slice",
    "data_axis": "--devices/--data-axis: the port trains on one card; "
                 "multi-card meshes are a later slice",
}


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--stage", type=int, default=None,
                    help="virtual pipeline stages on the card")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--compress", default="none", choices=("none", "int8", "fp8", "auto"),
                    help="quantize boundary activation/gradient transfers and "
                         "the gradient buckets")
    ap.add_argument("--quant-tile", type=int, default=256)
    ap.add_argument("--bucket-mb", type=float, default=None)
    ap.add_argument("--error-feedback", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    # repro's flags that belong to later slices: accepted by the parser so
    # they can be refused by name
    ap.add_argument("--plan", action="store_true", help="not ported yet")
    ap.add_argument("--profile", default=None, help="not ported yet")
    ap.add_argument("--portfolio", type=int, default=0, help="not ported yet")
    ap.add_argument("--events", default=None, help="not ported yet")
    ap.add_argument("--fail-at", type=int, default=None, help="not ported yet")
    ap.add_argument("--staleness", type=int, default=0, choices=(0, 1),
                    help="only 0 is ported")
    ap.add_argument("--double-buffer", action=argparse.BooleanOptionalAction,
                    default=None, help="not ported yet")
    ap.add_argument("--checkpoint-dir", default=None, help="not ported yet")
    ap.add_argument("--devices", type=int, default=0, help="not ported yet")
    ap.add_argument("--data-axis", type=int, default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag, why in _LATER.items():
        if getattr(args, flag) not in (None, False, 0):
            raise SystemExit(why)
    if args.staleness:
        raise SystemExit("--staleness 1 (bounded-stale async steps) is a later "
                         "slice of the port")
    if args.compress == "auto":
        raise SystemExit("--compress auto needs the planner (--plan), the next "
                         "slice of the port")
    if args.n_micro and args.global_batch % args.n_micro:
        raise SystemExit(f"--n-micro {args.n_micro} must divide "
                         f"--global-batch {args.global_batch}")
    return args


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, after_step=None) -> dict:
    """Run the launcher.  ``after_step(step, ts, params, batch)``, when
    given, runs after each step, before the step's timing mark.  Returns the
    per-step losses, the timing, the step and the final state."""
    args = _parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card found: the port trains on the card; "
                         "pass --device cpu to run the plain versions on the CPU")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime.train import build_train_step, init_train_state

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.n_layers:
        overrides["n_layers"] = args.n_layers
    if overrides:
        cfg = cfg.replace(**overrides)
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
          f"device={dev_name} (one card, virtual stages)")

    opt = AdamW(lr=cosine_schedule(args.lr, warmup=min(20, args.steps // 5),
                                   total=args.steps))
    ts = build_train_step(cfg, global_batch=args.global_batch, stage=args.stage,
                          n_micro=args.n_micro, optimizer=opt, compress=args.compress,
                          quant_tile=args.quant_tile, bucket_mb=args.bucket_mb,
                          error_feedback=args.error_feedback, device=device)
    spec = ts.spec
    print(f"plan: stage={spec.plan.stage} tp={spec.plan.tp} M={spec.n_micro} "
          f"shard_alloc=uniform staleness=0 double_buffer=False "
          f"compress={spec.compress}"
          + (f" bucket_mb={spec.bucket_mb:g}" if spec.bucket_mb else "")
          + (" ef" if spec.bucketed and spec.compress != "none"
             and spec.error_feedback else ""))

    params, opt_state = init_train_state(0, ts, opt)
    ds = SyntheticLM(cfg.vocab_size, args.seq)
    bucketed = spec.bucketed
    ef = ts.init_ef() if bucketed else None
    losses: list[float] = []
    _sync(device)
    t0 = time.perf_counter()
    t_warm = None
    loss = float("nan")
    for step in range(args.steps):
        batch = ts.shard_batch(ds.batch(step, args.global_batch))
        if bucketed:
            params, opt_state, ef, loss_t, metrics = ts.step_fn(params, opt_state, ef, batch)
        else:
            params, opt_state, loss_t, metrics = ts.step_fn(params, opt_state, batch)
        loss = float(loss_t)                       # waits for the step
        losses.append(loss)
        if after_step is not None:
            after_step(step, ts, params, batch)
        if step == 0 and args.steps > 1:
            _sync(device)
            t_warm = time.perf_counter()           # step 0 is warm-up: excluded from FINAL
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            tput = args.global_batch * args.seq * (step + 1) / dt
            print(f"step {step:5d} loss {loss:.4f} "
                  f"ce {float(metrics['ce']):.4f} tok/s {tput:,.0f}")
    _sync(device)
    t_end = time.perf_counter()
    tokens = args.global_batch * args.seq
    if t_warm is not None:
        timed, seconds = args.steps - 1, t_end - t_warm
    else:
        timed, seconds = args.steps, t_end - t0
    steady = tokens * timed / max(seconds, 1e-9)
    print(f"FINAL tok_s={steady:.1f} loss={loss:.4f}")
    print("done")
    return {"losses": losses, "tok_s": steady, "timed_steps": timed,
            "seconds": seconds, "ts": ts, "params": params, "opt_state": opt_state,
            "ef": ef, "device": dev_name}


if __name__ == "__main__":
    main()
