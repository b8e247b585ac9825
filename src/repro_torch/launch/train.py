"""Training launcher: the virtual-stage pipeline on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
        --stage 4 --n-micro 4 --global-batch 8 --seq 256 --steps 4 \\
        --compress int8 --bucket-mb 256 --no-error-feedback       # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --plan --profile prof.json \\
        --devices 4 --global-batch 8 --n-micro 4 --compress int8 \\
        --bucket-mb 256 --no-error-feedback --steps 4             # planned, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --plan --profile prof.json \\
        --devices 6 --global-batch 8 --n-micro 4 --compress int8 --staleness 1 \\
        --fail-at 3 --fail-rank 2 --backup-every 2 --steps 5  # prof.json: 3 x 36 GB
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --stage 2 --steps 2 --compress int8
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --plan --devices 2 --fail-at 2 --steps 4                  # the session on the CPU

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

``--staleness 1`` runs the bounded-stale step (``runtime.train``: round r's
update applied at the r+1 boundary, the end of training a flush) and
``--double-buffer`` (on by default at staleness 1) the boundary round trips
on a second stream, on either path.  ``--events`` (or ``--fail-at`` /
``--fail-rank``) with ``--plan`` trains through a live
``runtime.session.PipelineSession``: fail / join / drain / evict events at
given steps, stage backups every ``--backup-every`` steps, the replay
recovering without a restart; it prints ``repro``'s ``recovered (...)``,
``FINAL sim_tok_s=`` and ``FINAL tok_s=`` lines.  ``--checkpoint-dir``
saves the final parameters (``checkpoint.save``, ``repro``'s format).

Not ported yet, and refused by name: ``--portfolio``,
``--probation-rounds`` and ``--drift-threshold`` (the portfolio half of
the session layer).
"""

from __future__ import annotations

import argparse
import time

import torch

#: flags of ``repro.launch.train`` that need a later slice of the port
_LATER = {
    "portfolio": "--portfolio probes planner Plans in a live session "
                 "(the portfolio half of PipelineSession), a later slice of the port",
    "probation_rounds": "--probation-rounds belongs to --portfolio, a later slice of the port",
    "drift_threshold": "--drift-threshold arms the portfolio's drift watchdog, "
                       "a later slice of the port",
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
    ap.add_argument("--staleness", type=int, default=0, choices=(0, 1),
                    help="gradient staleness bound: 0 = synchronous rounds, 1 = "
                         "round r's update is applied at the r+1 boundary")
    ap.add_argument("--double-buffer", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="boundary round trips on a second stream; default: on "
                         "when --staleness 1")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the final parameters there (repro's format)")
    ap.add_argument("--events", default=None, metavar="SCHEDULE",
                    help="membership event schedule, comma-separated "
                         "'kind@step[:arg]' entries, e.g. 'join@40:a100,drain@80:2'. "
                         "Kinds: fail/drain/evict take a cluster rank (default: "
                         "last stage's lead device); join takes a device preset "
                         "(nano/tx2/nx/a100/v5e, default nx), a device-spec JSON "
                         "file ({name, mem_bytes, flops, ...}), or a "
                         "launch.profile artifact of the joining device. "
                         "Requires --plan")
    ap.add_argument("--hysteresis", type=float, default=None,
                    help="admission hysteresis margin for join events "
                         "(default: replay.ADMISSION_HYSTERESIS)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="sugar for --events 'fail@STEP[:--fail-rank]' (requires --plan)")
    ap.add_argument("--fail-rank", type=int, default=None,
                    help="cluster rank to kill (default: last stage's lead device)")
    ap.add_argument("--backup-every", type=int, default=5,
                    help="stage-replication cadence in steps (with --events)")
    # repro's flags that belong to a later slice: accepted by the parser so
    # they can be refused by name
    ap.add_argument("--portfolio", type=int, default=0, help="not ported yet")
    ap.add_argument("--probation-rounds", type=int, default=None, help="not ported yet")
    ap.add_argument("--drift-threshold", type=float, default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag, why in _LATER.items():
        if getattr(args, flag) not in (None, False, 0):
            raise SystemExit(why)
    args.events = _parse_events(args.events)
    if args.fail_at is not None:     # the old flags, kept as sugar
        arg = "" if args.fail_rank is None else str(args.fail_rank)
        args.events.append((args.fail_at, "fail", arg))
    args.events.sort(key=lambda e: e[0])
    if args.events and not args.plan:
        raise SystemExit("--events/--fail-at require --plan (the membership "
                         "session recovers by re-lowering a planner Plan)")
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


def main(argv=None, after_step=None, on_session=None) -> dict:
    """Run the launcher.  ``after_step(step, ts, params, batch)``, when
    given, runs after each step, before the step's timing mark;
    ``on_session(session)`` runs once the membership session is built.
    Returns the per-step losses, the timing, the step and the final state
    (and the session, on the ``--events`` path)."""
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
        spec_kw = dict(compress=run_compress, quant_tile=args.quant_tile,
                       bucket_mb=args.bucket_mb, error_feedback=args.error_feedback,
                       staleness=args.staleness, double_buffer=args.double_buffer)
        if args.events:
            from repro_torch.runtime.session import PipelineSession
            session = PipelineSession(cfg, model_axis, plan, prof, optimizer=opt,
                                      backup_every=args.backup_every, device=device,
                                      **spec_kw)
            lowered = session.lowered
            print(f"asteroid plan: {lowered.stage} stages periods="
                  f"{lowered.stage_periods} M={lowered.n_micro} "
                  f"K_p={lowered.warmup} predicted latency {plan.latency:.3f}s")
            _print_spec(session.ts.spec)
            if on_session is not None:
                on_session(session)
            res = _run_session(session, cfg, args, device, after_step)
            res.update(device=dev_name, plan=plan, profile=prof)
            return res
        ts, lowered = plan_to_train_step(plan, prof, cfg, model_axis, optimizer=opt,
                                         device=device, **spec_kw)
        print(f"asteroid plan: {lowered.stage} stages periods="
              f"{lowered.stage_periods} M={lowered.n_micro} "
              f"K_p={lowered.warmup} alloc={lowered.micro_alloc} "
              f"predicted latency {plan.latency:.3f}s")
    else:
        ts = build_train_step(cfg, global_batch=args.global_batch, stage=args.stage,
                              n_micro=args.n_micro, optimizer=opt, compress=args.compress,
                              quant_tile=args.quant_tile, bucket_mb=args.bucket_mb,
                              error_feedback=args.error_feedback, staleness=args.staleness,
                              double_buffer=args.double_buffer, device=device)
    spec = ts.spec
    _print_spec(spec)

    params, opt_state = init_train_state(0, ts, opt)
    ds = SyntheticLM(cfg.vocab_size, args.seq)
    bucketed = spec.bucketed
    ef = ts.init_ef() if bucketed else None
    held = None
    losses: list[float] = []
    # steady state starts after the warm-up round(s): the first step, and
    # at staleness 1 also the first full round (round 0 takes gradients only)
    n_warm = 2 if spec.staleness >= 1 else 1
    _sync(device)
    t0 = time.perf_counter()
    t_warm = None
    loss = float("nan")
    for step in range(args.steps):
        batch = ts.shard_batch(ds.batch(step, args.global_batch))
        if spec.staleness >= 1:
            if bucketed:
                params, opt_state, held, ef, loss_t, metrics = ts.async_step_fn(
                    params, opt_state, held, ef, batch)
            else:
                params, opt_state, held, loss_t, metrics = ts.async_step_fn(
                    params, opt_state, held, batch)
        elif bucketed:
            params, opt_state, ef, loss_t, metrics = ts.step_fn(params, opt_state, ef, batch)
        else:
            params, opt_state, loss_t, metrics = ts.step_fn(params, opt_state, batch)
        loss = float(loss_t)                       # waits for the step
        losses.append(loss)
        if after_step is not None:
            after_step(step, ts, params, batch)
        if step == n_warm - 1 and args.steps > n_warm:
            _sync(device)
            t_warm = time.perf_counter()           # warm-up excluded from FINAL
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            tput = args.global_batch * args.seq * (step + 1) / dt
            print(f"step {step:5d} loss {loss:.4f} "
                  f"ce {float(metrics['ce']):.4f} tok/s {tput:,.0f}")
    _sync(device)
    t_end = time.perf_counter()
    if held is not None:                           # staleness barrier: the last round
        params, opt_state = ts.flush_fn(params, opt_state, held)
        _sync(device)
    timed, seconds, steady = _steady(args, n_warm, t0, t_warm, t_end)
    _save_checkpoint(args, params)
    print(f"FINAL tok_s={steady:.1f} loss={loss:.4f}")
    print("done")
    return {"losses": losses, "tok_s": steady, "timed_steps": timed,
            "seconds": seconds, "ts": ts, "params": params, "opt_state": opt_state,
            "ef": ef, "device": dev_name, "plan": plan, "lowered": lowered,
            "profile": prof}


def _print_spec(spec) -> None:
    print(f"plan: stage={spec.plan.stage} tp={spec.plan.tp} M={spec.n_micro} "
          f"shard_alloc=uniform staleness={spec.staleness} "
          f"double_buffer={spec.double_buffer} compress={spec.compress}"
          + (f" bucket_mb={spec.bucket_mb:g}" if spec.bucket_mb else "")
          + (" ef" if spec.bucketed and spec.compress != "none"
             and spec.error_feedback else ""))


def _steady(args, n_warm: int, t0: float, t_warm, t_end: float):
    """``(timed steps, seconds, tok/s)`` of the steps after the warm-up
    (over the whole run when no step followed it); shared by both paths."""
    if t_warm is not None:
        timed, seconds = args.steps - n_warm, t_end - t_warm
    else:
        timed, seconds = args.steps, t_end - t0
    return timed, seconds, args.global_batch * args.seq * timed / max(seconds, 1e-9)


def _save_checkpoint(args, params) -> None:
    if args.checkpoint_dir:
        from repro_torch import checkpoint
        checkpoint.save(args.checkpoint_dir, "final", params)
        print(f"checkpoint saved to {args.checkpoint_dir}")


def _parse_events(spec: str | None) -> list:
    """Parse a ``--events`` schedule into ``(step, kind, arg)`` triples."""
    events = []
    if not spec:
        return events
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        head, _, arg = entry.partition(":")
        kind, at, step = head.partition("@")
        kind = kind.strip().lower()
        if kind not in ("fail", "join", "drain", "evict") or not at:
            raise SystemExit(f"--events entry {entry!r} is not 'kind@step[:arg]' "
                             "with kind in fail/join/drain/evict")
        try:
            events.append((int(step), kind, arg.strip()))
        except ValueError:
            raise SystemExit(f"--events entry {entry!r}: step {step!r} is not an integer")
    return events


def _resolve_join(arg: str):
    """A join event's argument -> ``(device, arrival_sweep)``: a preset name
    or device-spec JSON prices the newcomer analytically; a
    ``launch.profile`` artifact supplies its measured on-arrival sweep."""
    import json

    from repro_torch.core.hardware import (A100, JETSON_NANO, JETSON_NX, JETSON_TX2,
                                           TPU_V5E, DeviceProfile)
    presets = {"nano": JETSON_NANO, "tx2": JETSON_TX2, "nx": JETSON_NX,
               "a100": A100, "v5e": TPU_V5E}
    if not arg:
        return JETSON_NX, None
    if arg.lower() in presets:
        return presets[arg.lower()], None
    with open(arg) as f:
        doc = json.load(f)
    if "batch_sizes" in doc and "tf" in doc:     # a measured sweep artifact
        from repro_torch.core.profiler import load_profile
        return None, load_profile(arg)
    try:
        dev = DeviceProfile(name=doc.get("name", "custom"),
                            mem_bytes=float(doc["mem_bytes"]), flops=float(doc["flops"]),
                            **{k: doc[k] for k in ("sat_batch", "sat_flops", "overhead")
                               if k in doc})
    except KeyError as e:
        raise SystemExit(f"join device spec {arg} is missing {e} (need at least "
                         "name/mem_bytes/flops, or pass a launch.profile artifact)")
    return dev, None


def _apply_event(session, kind: str, arg: str, args) -> None:
    """Fire one membership event on the live session and report it."""
    from repro_torch.core.replay import ADMISSION_HYSTERESIS

    if kind == "join":
        device, arrival = _resolve_join(arg)
        out = session.admit(device, arrival=arrival,
                            hysteresis=(args.hysteresis if args.hysteresis is not None
                                        else ADMISSION_HYSTERESIS))
        dec = out.decision
        if not out.accepted:
            print(f"  join rejected ({dec.reason})")
            return
        rep = out.report
        print(f"  joined ({dec.reason}): replan {rep.replan_s * 1e3:.1f}ms "
              f"migrate {rep.migration_s:.2f}s replicate {rep.replicate_s:.2f}s | "
              f"{dec.incumbent_latency:.3f}s -> {dec.candidate_latency:.3f}s/round | "
              f"new stages {[(st.layers, st.group) for st in session.plan.stages]}")
        return
    rank = int(arg) if arg else session.plan.stages[-1].group[0]
    if kind == "fail":
        print(f"  killing rank {rank}")
        session.fail(rank)      # detected and recovered inside the next step
        return
    out = session.drain(rank) if kind == "drain" else session.evict(rank)
    rep = out.report
    print(f"  {kind} rank {rank} ({out.mode}{', overlapped' if rep.overlapped else ''}): "
          f"replan {rep.replan_s * 1e3:.1f}ms migrate {rep.migration_s:.2f}s "
          f"stall {out.stall_s:.3f}s | new stages "
          f"{[(st.layers, st.group) for st in session.plan.stages]}")


def _run_session(session, cfg, args, device, after_step=None) -> dict:
    """Drive a live membership session: train through the scheduled
    join/drain/evict/fail events without restarting."""
    from repro_torch.data import SyntheticLM

    session.init(0)
    ds = SyntheticLM(cfg.vocab_size, args.seq)
    loss = float("nan")
    losses: list[float] = []
    seen_recoveries = 0
    pending = list(args.events)
    sim_busy = 0.0          # cluster round time under the deployed plan
    n_warm = 2 if session.ts.spec.staleness >= 1 else 1
    _sync(device)
    t0 = time.perf_counter()
    t_warm = None
    for step in range(args.steps):
        while pending and pending[0][0] <= step:
            _, kind, arg = pending.pop(0)
            print(f"step {step}: {kind} event")
            _apply_event(session, kind, arg, args)
        batch_np = ds.batch(step, args.global_batch)
        loss, metrics = session.step(batch_np)
        losses.append(loss)
        sim_busy += session.plan.latency
        if after_step is not None:
            after_step(step, session.ts, session.params, batch_np)
        if step == n_warm - 1 and args.steps > n_warm:
            _sync(device)
            t_warm = time.perf_counter()
        if len(session.recoveries) > seen_recoveries:
            seen_recoveries = len(session.recoveries)
            out = session.recoveries[-1]
            rep = out.report
            print(f"  recovered ({out.mode}): detect {rep.detection_s:.2f}s "
                  f"replan {rep.replan_s * 1e3:.1f}ms migrate {rep.migration_s:.2f}s "
                  f"restore {rep.restore_s:.2f}s | moved periods "
                  f"{out.migration.moved_periods} restored {out.restored_periods} | "
                  f"new stages {[(st.layers, st.group) for st in session.plan.stages]}")
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            tput = args.global_batch * args.seq * (step + 1) / dt
            print(f"step {step:5d} loss {loss:.4f} "
                  f"ce {float(metrics['ce']):.4f} tok/s {tput:,.0f}")
    _sync(device)
    t_end = time.perf_counter()
    session.flush_gradients()       # staleness barrier at the end of training
    _sync(device)
    _save_checkpoint(args, session.params)
    timed, seconds, tput = _steady(args, n_warm, t0, t_warm, t_end)
    # throughput on the simulated cluster clock: the round latency of the
    # plan deployed at each step, plus the stall every transition charged
    stalls = sum(o.stall_s for o in session.memberships)
    sim_tput = args.global_batch * args.seq * args.steps / max(sim_busy + stalls, 1e-9)
    print(f"FINAL sim_tok_s={sim_tput:.1f} (rounds {sim_busy:.2f}s + "
          f"membership stalls {stalls:.3f}s)")
    print(f"FINAL tok_s={tput:.1f} loss={loss:.4f}")
    print("done")
    return {"losses": losses, "tok_s": tput, "sim_tok_s": sim_tput, "timed_steps": timed,
            "seconds": seconds, "session": session, "ts": session.ts,
            "params": session.params, "opt_state": session.opt_state,
            "lowered": session.lowered}


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
