"""Serving launcher: lockstep or continuous batched decode on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
        --smoke --batch 8 --prompt-len 16 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b   # on the card

``--devices N`` lays out ``repro``'s mesh, all virtual on the one card: a
data axis of max(1, N // 4) and a model axis of the rest.  Both paths
build their step on it.  The batch is cut into the data shards, and the
model axis into stages and tp.

The lockstep path of ``repro.launch.serve``: random weights from seed 0
(without an MTP head, which serving never reads: ``repro``'s launcher sets
``mtp_depth=0``),
a random prompt fed one token per decode step, then ``--gen`` tokens
sampled from ``softmax(logits / T)`` with a seeded ``torch.Generator`` on
the device (not ``repro``'s JAX draws, so the tokens differ).  Its step
is ``build_serve_step`` at ``pick_serve_stage``'s stage count on the
model axis, with the data axis: an MoE layer routes each data shard's
rows of a decode group as ``repro``'s step does.  ``--batch`` must split
into the data shards.

Continuous batching (``--continuous``, ``repro``'s ``run_continuous``):
``plan_serve`` picks the stage count and the uneven slot split across data
shards against a *modeled* edge cluster (Jetson NX / TX2 shard blocks,
``Profile.analytic``), ``build_slot_serve_step`` lowers it onto the
card's virtual mesh, and an open-loop Poisson stream is served through
``ContinuousBatcher``:

    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --devices 8 \\
        --requests 12 --prompt-len 16 --gen 32 --max-slots 4      # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --continuous --devices 8 --requests 4 --gen 4

The plan's latencies are the Jetson model's; the engine step, tok/s and
token-latency percentiles are measured where the step runs, on a clock that
advances by each engine step and the host draws after it.  Runs on
``cuda`` unless ``--device cpu`` is given; without a card it stops rather
than running on the CPU.  ``--seq-shard`` (the cache sharded over the data
axis) is refused.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to its first N layers (widths unchanged), "
                         "as launch.train's --n-layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    ap.add_argument("--seq-shard", action="store_true", help="not ported yet")
    ap.add_argument("--devices", type=int, default=1,
                    help="virtual devices of the mesh, lockstep and --continuous: "
                         "a data axis of max(1, N // 4) and the model axis the rest")
    ap.add_argument("--continuous", action="store_true",
                    help="planner-driven continuous batching "
                         "(plan_serve -> slot step -> Poisson stream)")
    ap.add_argument("--requests", type=int, default=12,
                    help="--continuous: requests in the Poisson trace")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="--continuous: offered load (tokens/s); default "
                         "derives from the measured step time and --util")
    ap.add_argument("--util", type=float, default=0.6,
                    help="--continuous: target utilization for the "
                         "derived offered load")
    ap.add_argument("--max-slots", type=int, default=4,
                    help="--continuous: per-shard slot cap handed to the "
                         "planner as profile.max_batch")
    args = ap.parse_args(argv)
    if args.seq_shard:
        ap.error("--seq-shard is not ported yet: it shards the cache over a data "
                 "axis of devices, and the port's data shards are row blocks on one card")
    if args.prompt_len < 1 or args.gen < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen must be >= 1")
    if args.n_layers is not None and args.n_layers < 1:
        ap.error("--n-layers must be >= 1")
    if args.devices < 1 or args.requests < 1 or args.max_slots < 1 \
            or not 0 < args.util or args.rate < 0:
        ap.error("--devices, --requests and --max-slots must be >= 1, --util > 0, "
                 "--rate >= 0")
    if args.temperature <= 0:
        ap.error("--temperature must be > 0")
    if not args.continuous and args.batch % mesh_axes(args.devices)[0]:
        ap.error(f"--batch {args.batch} does not split into the "
                 f"{mesh_axes(args.devices)[0]} data shards of --devices {args.devices}")
    return args


def mesh_axes(devices: int) -> tuple[int, int]:
    """``repro``'s launcher mesh on ``devices`` devices: (data, model)."""
    data = max(1, devices // 4)
    return data, devices // data


PROBE_STEPS = 5          # --continuous: engine steps timed for the offered load


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lockstep_serve_step(cfg, *, devices: int, batch: int, cache_len: int):
    """The lockstep step on ``repro``'s launcher mesh for ``devices``
    devices: the data axis, and ``pick_serve_stage``'s stages on the model
    axis (``repro``'s ``build_serve_step`` defaults)."""
    from repro_torch.runtime.serve import build_serve_step, pick_serve_stage

    data, model_axis = mesh_axes(devices)
    return build_serve_step(cfg, batch_global=batch, cache_len=cache_len,
                            stage=pick_serve_stage(cfg, model_axis), data=data,
                            model_axis=model_axis)


def lockstep_decode(cfg, params, *, batch: int, prompt_len: int, gen: int,
                    temperature: float, device, step=None) -> dict:
    """Decode ``batch`` random prompts (numpy seed 0) in lockstep on
    ``params``' device, on the serve step ``step`` (default
    :func:`lockstep_serve_step` on one device): one prompt token per step,
    then ``gen`` tokens sampled from ``softmax(logits / T)``.  Returns the
    timing, the step and the (T, B) token array."""
    from repro_torch.runtime.serve import prepare_serve_states

    cache_len = prompt_len + gen
    ss = step or lockstep_serve_step(cfg, devices=1, batch=batch, cache_len=cache_len)
    states = prepare_serve_states(cfg, ss.spec.plan, batch, cache_len, device)
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          size=(prompt_len, batch))).to(device)
    sampler = torch.Generator(device=device).manual_seed(0)

    seqs = [prompt[t] for t in range(prompt_len)]
    tok = prompt[0]
    _sync(device)
    t0 = time.perf_counter()
    for pos in range(cache_len - 1):
        logits, states = ss.step_fn(params, tok, pos, states)
        if pos + 1 < prompt_len:
            tok = prompt[pos + 1]
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=sampler)[:, 0]
            seqs.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    gen_tokens = gen * batch
    return {"steps": cache_len - 1, "seconds": dt, "tokens": torch.stack(seqs).cpu().numpy(),
            "tok_per_s": gen_tokens / dt, "serve_step": ss}


def serve_plan(cfg, *, dp: int, model_axis: int, cache_len: int, max_slots: int,
               util: float):
    """``plan_serve`` on the modeled edge cluster of ``repro``'s launcher:
    data shard d is a block of ``model_axis`` Jetson NX (d even) or TX2 (d
    odd) devices on 100 Mbps links, priced by ``Profile.analytic`` with
    ``max_slots`` as the per-shard cap, at ``util`` of the equal-split
    capacity (so the greedy split has queueing pressure to plan against)."""
    from repro_torch.core.hardware import JETSON_NX, JETSON_TX2, MBPS_100, Cluster
    from repro_torch.core.planner import (_price_serve_alloc, _serve_cuts,
                                          plan_serve, serve_stage_candidates)
    from repro_torch.core.profiler import LayerTable, Profile
    from repro_torch.runtime.serve import serve_head_count

    devs = tuple((JETSON_NX if d % 2 == 0 else JETSON_TX2,) * model_axis
                 for d in range(dp))
    cluster = Cluster(sum(devs, ()), bandwidth=MBPS_100)
    table = LayerTable.from_model_config(cfg, seq_len=cache_len)
    prof = Profile.analytic(table, cluster, max_batch=max_slots)
    stage0 = serve_stage_candidates(model_axis, serve_head_count(cfg))[0]
    cuts0 = _serve_cuts(table.L, stage0)
    cap = 0.0
    for y in range(1, max_slots + 1):
        st, _, _ = _price_serve_alloc(prof, [y] * dp, stage=stage0,
                                      tp=model_axis // stage0, cuts=cuts0,
                                      seq_len=cache_len, arrival_rate=0.0,
                                      compress=None)
        cap = max(cap, dp * y / st if st > 0 else 0.0)
    return plan_serve(prof, util * cap, dp_shards=dp, model_axis=model_axis,
                      n_heads=serve_head_count(cfg), cache_len=cache_len,
                      seq_len=cache_len, arch=cfg.name)


def run_continuous(args, cfg, device, dev_name: str) -> dict:
    """Planner-driven continuous batching on one card (``repro``'s
    ``run_continuous``).  Returns the plan, the slot step, the weights, the
    requests, the completions, the engine's step times and the figures
    printed."""
    from repro_torch.core.costmodel import serve_latency_quantile
    from repro_torch.models.model import init_model
    from repro_torch.runtime.continuous import (ContinuousBatcher,
                                                engine_from_serve_step,
                                                poisson_requests, sample_token,
                                                slot_rows)
    from repro_torch.runtime.serve import build_slot_serve_step

    dp, model_axis = mesh_axes(args.devices)
    cache_len = args.prompt_len + args.gen
    plan = serve_plan(cfg, dp=dp, model_axis=model_axis, cache_len=cache_len,
                      max_slots=args.max_slots, util=args.util)
    print(f"serve plan: stage={plan.stage} tp={plan.tp} alloc={plan.shard_alloc} "
          f"caps={plan.max_slots} modeled p99={plan.predicted_p99 * 1e3:.2f}ms "
          f"(Jetson NX/TX2 model, {dp} x {model_axis} devices)")

    ss = build_slot_serve_step(cfg, cache_len=cache_len, shard_alloc=plan.shard_alloc,
                               stage=plan.stage, model_axis=model_axis)
    params = init_model(torch.Generator(device=device).manual_seed(0), cfg, device)
    engine = engine_from_serve_step(ss, params, device)

    B = ss.spec.batch_global
    slots = slot_rows(plan.shard_alloc)
    zeros = np.zeros(B, np.int32)
    engine(zeros, zeros, np.ones(B, bool))                     # warm-up
    probes = []                     # one step on a shared host can be far off
    for _ in range(PROBE_STEPS):
        t0 = time.perf_counter()
        logits = engine(zeros, zeros, np.zeros(B, bool))       # the host copy waits
        t1 = time.perf_counter()
        for r in slots:
            sample_token(logits[r], 0, r, 0)
        probes.append((t1 - t0, time.perf_counter() - t1))
    step_s, draw_s = (float(np.median(v)) for v in zip(*probes))
    service_s = step_s + draw_s
    rate = args.rate or args.util * plan.slots / service_s
    print(f"engine step {step_s * 1e3:.3f} ms + {len(slots)} host draws "
          f"{draw_s * 1e3:.3f} ms (medians of {PROBE_STEPS}) on {dev_name} "
          f"({B} rows, {plan.slots} live) -> "
          f"offered load {rate:.1f} tok/s ({args.util:.0%} of capacity)")

    reqs = poisson_requests(rate / args.gen, horizon=args.requests * args.gen / rate,
                            n_tokens=args.gen, seed=0, vocab=cfg.vocab_size)
    if not reqs:
        raise SystemExit("the Poisson trace holds no request: raise --requests")
    bat = ContinuousBatcher(engine, slots=slots, batch=B, cache_len=cache_len, seed=0,
                            draws_on_clock=True)
    done = bat.run(reqs)
    lats = np.array([lat for c in done for lat in c.token_latencies])
    total = sum(len(c.tokens) for c in done)
    span = max(c.finish for c in done) - min(c.arrival for c in done)
    pct = np.percentile(lats, [50, 95, 99])
    pred = [serve_latency_quantile(service_s, plan.slots, rate, p)
            for p in (0.5, 0.95, 0.99)]
    mean_step, mean_draw = float(np.mean(bat.step_seconds)), float(np.mean(bat.draw_seconds))
    print(f"served {len(done)} requests / {total} tokens in {bat.steps} steps: "
          f"{total / span:.1f} tok/s on {dev_name} (clock: engine + host draws); "
          f"engine {mean_step * 1e3:.3f} ms/step, draws {mean_draw * 1e3:.3f} ms/step")
    print(f"token latency p50/p95/p99 = {pct[0] * 1e3:.3f}/{pct[1] * 1e3:.3f}/"
          f"{pct[2] * 1e3:.3f} ms (predicted from the measured step and draws: "
          f"{pred[0] * 1e3:.3f}/{pred[1] * 1e3:.3f}/{pred[2] * 1e3:.3f} ms)")
    # a token's latency runs from its slot's last token (or admission): the
    # wait for a free slot is the admission wait, which the first token adds
    admit = np.array([max(0.0, c.finish - sum(c.token_latencies) - c.arrival) for c in done])
    first = admit + np.array([c.token_latencies[0] for c in done])
    wait_pct, ttft_pct = np.percentile(admit, [50, 95, 99]), np.percentile(first, [50, 95, 99])
    print(f"admission wait p50/p95/p99 = {'/'.join(f'{v * 1e3:.3f}' for v in wait_pct)} ms; "
          f"first token p50/p95/p99 = {'/'.join(f'{v * 1e3:.3f}' for v in ttft_pct)} ms "
          f"after arrival")
    print("done")
    return {"plan": plan, "slot_step": ss, "params": params, "requests": reqs,
            "slots": slots, "completions": done, "step_seconds": list(bat.step_seconds),
            "draw_seconds": list(bat.draw_seconds), "steps": bat.steps,
            "warmup_calls": 1 + PROBE_STEPS,
            "probe_step_s": step_s, "probe_draw_s": draw_s, "rate": rate,
            "tok_per_s": total / span, "latency_pct": tuple(float(v) for v in pct),
            "predicted_pct": tuple(pred), "admission_wait_pct": tuple(map(float, wait_pct)),
            "first_token_pct": tuple(map(float, ttft_pct)), "device": dev_name}


def main(argv=None) -> dict:
    """Run the launcher; returns the timing, the step, the weights and the
    (T, B) token array (lockstep), or ``run_continuous``'s dict
    (``--continuous``)."""
    args = _parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card found: the port serves on the card; "
                         "pass --device cpu to run the plain versions on the CPU")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import init_model

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(mtp_depth=0)            # no serve step reads an MTP head
    if args.n_layers:
        cfg = cfg.replace(n_layers=args.n_layers)
    cache_len = args.prompt_len + args.gen
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if args.continuous:
        return run_continuous(args, cfg, device, dev_name)
    ss = lockstep_serve_step(cfg, devices=args.devices, batch=args.batch,
                             cache_len=cache_len)
    plan = ss.spec.plan
    data = f" data={plan.data}" if plan.data > 1 else ""
    print(f"arch={cfg.name} serve plan: stage={plan.stage} tp={plan.tp}{data} "
          f"cache={cache_len} device={dev_name}")

    params = init_model(torch.Generator(device=device).manual_seed(0), cfg, device)
    res = lockstep_decode(cfg, params, batch=args.batch, prompt_len=args.prompt_len,
                          gen=args.gen, temperature=args.temperature, device=device,
                          step=ss)
    dt, steps = res["seconds"], res["steps"]
    print(f"decoded {args.gen} steps x batch {args.batch} in {dt:.3f}s "
          f"({res['tok_per_s']:.1f} tok/s on {dev_name}; "
          f"{steps} decode steps, {dt / steps * 1e3:.3f} ms/step)")
    print("sample sequence 0:", res["tokens"][:24, 0], "...")
    print("done")
    return {**res, "params": params, "device": dev_name}


if __name__ == "__main__":
    main()
