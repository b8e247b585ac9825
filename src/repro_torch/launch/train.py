"""Training launcher: the virtual-stage pipeline on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --stage 4 --n-micro 4 --global-batch 8 --seq 256 --steps 4 \\
        --compress int8 --bucket-mb 256 --no-error-feedback       # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --plan --profile prof.json \\
        --devices 4 --global-batch 8 --n-micro 4 --compress int8 \\
        --bucket-mb 256 --no-error-feedback --steps 4             # planned, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --stage 2 --steps 2 --compress int8

The port of ``repro.launch.train``.  Without ``--plan``: ``build_train_step``
with ``--stage`` virtual stages and ``--n-micro`` micro-batches.  With
``--plan``: the paper's loop — a ``Profile`` (measured, from a
``launch.profile`` artifact given by ``--profile``, else analytic for the
edge cluster ``--env``), ``plan_hpp`` (Algorithms 1 and 2) over the
divisors of the model axis, ``lower_plan`` and
``build_train_step_from_lowered``, whose stages own the planner's period
ranges.  Both run AdamW on a cosine schedule over ``SyntheticLM`` batches
(bit-identical to ``repro``'s), with the compressed wire under
``--compress``, and print ``repro``'s ``plan:``, ``step ... loss ... ce ...
tok/s ...`` and ``FINAL tok_s=... loss=...`` lines (``--plan`` adds its
``profile=...`` and ``asteroid plan: ...`` lines).  Weights are random from
seed 0 (``torch.Generator`` draws, not JAX's).

``--devices N`` (with ``--plan``) is the virtual model axis of one card
(default 1): the stage counts a plan may take are its divisors, and tp =
N / stages is a label, the math being unsharded.  ``repro`` puts a data axis of
``max(1, N // 4)`` beside it, so ``--devices`` of 8 or more, like
``--data-axis`` above 1, would need real data parallelism and is refused.
Runs on ``cuda`` unless ``--device cpu`` is given; without a card it stops
rather than running on the CPU.

Not ported yet, and refused: ``--staleness 1`` and ``--double-buffer``,
``--portfolio``, ``--events``/``--fail-at`` (the session layer), and
``--checkpoint-dir``.
"""

from __future__ import annotations

import argparse
import time

import torch

#: flags of ``repro.launch.train`` that need a later slice of the port
_LATER = {
    "portfolio": "--portfolio probes planner Plans in a live session "
                 "(PipelineSession), a later slice of the port",
    "events": "--events/--fail-at need PipelineSession (membership), a later slice of the port",
    "fail_at": "--events/--fail-at need PipelineSession (membership), a later slice of the port",
    "double_buffer": "--double-buffer (overlapped sends) is a later slice of the port",
    "checkpoint_dir": "--checkpoint-dir needs checkpoint/, a later slice of the port",
}
_MAX_DEVICES = 7       # repro's data axis max(1, N // 4) stays 1 below 8


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default=None,
                    help="architecture id (default phi3-mini-3.8b, or the "
                         "--profile artifact's recorded arch)")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--devices", type=int, default=0,
                    help="virtual model axis of the card for --plan (default 1)")
    ap.add_argument("--data-axis", type=int, default=None,
                    help="only 1: one card has one data shard")
    ap.add_argument("--stage", type=int, default=None,
                    help="virtual pipeline stages on the card (without --plan)")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default 128, or the --profile "
                         "artifact's recorded seq_len)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--plan", action="store_true",
                    help="derive stage split / n_micro / K_p from the "
                         "Asteroid planner (Algorithm 2) and lower it")
    ap.add_argument("--no-offload", action="store_true",
                    help="disable Algorithm 1 Phase 2 (straggler workload "
                         "offloading) when planning")
    ap.add_argument("--force-offload", action="store_true",
                    help="always keep the Phase 2 allocation (default: "
                         "'auto', kept only when it prices strictly faster)")
    ap.add_argument("--compress", default="none", choices=("none", "int8", "fp8", "auto"),
                    help="quantize boundary activation/gradient transfers and "
                         "the gradient buckets; 'auto' (requires --plan) lets "
                         "the planner keep compression only when it prices "
                         "strictly faster")
    ap.add_argument("--quant-tile", type=int, default=256)
    ap.add_argument("--bucket-mb", type=float, default=None)
    ap.add_argument("--error-feedback", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--env", default="D", choices=list("ABCD"),
                    help="edge environment (analytic profile) for --plan; "
                         "ignored when a valid --profile artifact is given")
    ap.add_argument("--bandwidth", type=float, default=None, metavar="MBPS",
                    help="override the analytic environment's D2D link "
                         "bandwidth (megabits/s; default: the env preset's)")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="measured profile artifact from "
                         "repro_torch.launch.profile; falls back to the "
                         "analytic model with a warning if it is stale")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    # repro's flags that belong to later slices: accepted by the parser so
    # they can be refused by name
    ap.add_argument("--portfolio", type=int, default=0, help="not ported yet")
    ap.add_argument("--events", default=None, help="not ported yet")
    ap.add_argument("--fail-at", type=int, default=None, help="not ported yet")
    ap.add_argument("--staleness", type=int, default=0, choices=(0, 1),
                    help="only 0 is ported")
    ap.add_argument("--double-buffer", action=argparse.BooleanOptionalAction,
                    default=None, help="not ported yet")
    ap.add_argument("--checkpoint-dir", default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag, why in _LATER.items():
        if getattr(args, flag) not in (None, False, 0):
            raise SystemExit(why)
    if args.staleness:
        raise SystemExit("--staleness 1 (bounded-stale async steps) is a later "
                         "slice of the port")
    if args.devices > _MAX_DEVICES:
        raise SystemExit(f"--devices {args.devices}: repro's data axis would be "
                         f"{args.devices // 4}; real data parallelism across "
                         "cards is a later slice of the port")
    if args.data_axis not in (None, 1):
        raise SystemExit(f"--data-axis {args.data_axis}: the port trains one data "
                         "shard; real data parallelism is a later slice of the port")
    if args.profile and not args.plan:
        raise SystemExit("--profile requires --plan (a measured profile only "
                         "feeds the planner)")
    if args.devices and not args.plan:
        raise SystemExit("--devices requires --plan (the virtual model axis only "
                         "bounds the planner's stage counts; use --stage)")
    if args.compress == "auto" and not args.plan:
        raise SystemExit("--compress auto requires --plan (the planner prices "
                         "the compressed vs raw wire)")
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

    # a --profile artifact supplies the model/seq it was measured for;
    # explicit flags still win (a mismatch then falls back to analytic)
    measured = None
    if args.profile:
        from repro_torch.core.profiler import load_profile
        measured = load_profile(args.profile)
        if args.arch is None and "arch_id" in measured.meta:
            args.arch = measured.meta["arch_id"]
        if args.seq is None:
            args.seq = measured.seq_len
        if not args.smoke and measured.meta.get("smoke"):
            print(f"adopting --smoke from profile artifact {args.profile}")
            args.smoke = True
    args.arch = args.arch or "phi3-mini-3.8b"
    args.seq = args.seq or 128

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.n_layers:
        overrides["n_layers"] = args.n_layers
    if overrides:
        cfg = cfg.replace(**overrides)
    model_axis = max(args.devices, 1)
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
          f"mesh=(data=1, model={model_axis}) device={dev_name} "
          f"(one card, virtual stages)")

    opt = AdamW(lr=cosine_schedule(args.lr, warmup=min(20, args.steps // 5),
                                   total=args.steps))
    plan = lowered = prof = None
    if args.plan:
        plan, prof = _plan(args, cfg, measured, model_axis, device)
        from repro_torch.core.lowering import plan_to_train_step
        # the runtime executes whatever the (possibly 'auto') plan chose
        run_compress = plan.compress.fmt if plan.compress else "none"
        ts, lowered = plan_to_train_step(plan, prof, cfg, model_axis, optimizer=opt,
                                         compress=run_compress,
                                         quant_tile=args.quant_tile,
                                         bucket_mb=args.bucket_mb,
                                         error_feedback=args.error_feedback,
                                         device=device)
        print(f"asteroid plan: {lowered.stage} stages periods="
              f"{lowered.stage_periods} M={lowered.n_micro} "
              f"K_p={lowered.warmup} alloc={lowered.micro_alloc} "
              f"predicted latency {plan.latency:.3f}s")
    else:
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
            "ef": ef, "device": dev_name, "plan": plan, "lowered": lowered,
            "profile": prof}


def _plan(args, cfg, measured, model_axis: int, device):
    """``repro``'s ``--plan`` block: the profile (measured when the artifact
    still describes this run, else analytic for ``--env``) and the
    ``plan_hpp`` plan over the divisors of the model axis."""
    from repro_torch.core.costmodel import CompressionConfig
    from repro_torch.core.hardware import ENVS, Cluster
    from repro_torch.core.planner import plan_hpp
    from repro_torch.core.profiler import LayerTable, Profile, resolve_profile

    table = LayerTable.from_model_config(cfg, args.seq)
    max_batch = max(args.global_batch, 1)
    prof = resolve_profile(measured, cfg, args.seq, table, max_batch,
                           label=f"measured profile {args.profile}",
                           fallback_note=f" (env {args.env})", device=device)
    if prof is not None:
        print(f"profile=measured({args.profile}, "
              f"{len(prof.cluster.devices)} devices, "
              f"batches<={max(measured.batch_sizes)} measured)")
    else:
        cluster = ENVS[args.env]()
        if args.bandwidth:
            cluster = Cluster(cluster.devices, args.bandwidth * 1e6 / 8)
        prof = Profile.analytic(table, cluster.sorted_by_memory(), max_batch=max_batch)
        print(f"profile=analytic(env {args.env}"
              + (f", {args.bandwidth:g} Mbps" if args.bandwidth else "") + ")")
    n_periods = cfg.n_layers // len(cfg.pattern)
    divisors = {d for d in range(1, model_axis + 1)
                if model_axis % d == 0 and d <= n_periods}
    if args.n_micro:
        mb = args.global_batch // args.n_micro
    else:
        m = next(m for m in (4, 2, 1) if args.global_batch % m == 0)
        mb = args.global_batch // m
    if args.no_offload:
        intra_opt = False
    elif args.force_offload:
        intra_opt = True
    else:
        intra_opt = "auto"
    if args.compress == "auto":
        plan_compress = "auto"
    elif args.compress != "none":
        plan_compress = CompressionConfig(fmt=args.compress, tile=args.quant_tile,
                                          bucket_mb=args.bucket_mb,
                                          error_feedback=args.error_feedback)
    else:
        plan_compress = None
    plan = plan_hpp(prof, args.global_batch, mb, arch=cfg.name,
                    allowed_stages=divisors, intra_opt=intra_opt,
                    staleness=args.staleness, compress=plan_compress)
    return plan, prof


if __name__ == "__main__":
    main()
