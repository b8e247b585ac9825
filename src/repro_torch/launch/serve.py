"""Serving launcher: batched lockstep autoregressive decode on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \\
        --smoke --batch 8 --prompt-len 16 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b   # on the card

The lockstep path of ``repro.launch.serve``: random weights from seed 0,
a random prompt fed one token per decode step, then ``--gen`` tokens
sampled from ``softmax(logits / T)`` with a seeded ``torch.Generator`` on
the device (not ``repro``'s JAX draws, so the tokens differ).  Runs on
``cuda`` unless ``--device cpu`` is given; without a card it stops rather
than running on the CPU.
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
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    ap.add_argument("--seq-shard", action="store_true", help="not ported yet")
    ap.add_argument("--continuous", action="store_true", help="not ported yet")
    args = ap.parse_args(argv)
    if args.continuous or args.seq_shard:
        ap.error("--continuous and --seq-shard are not ported yet; the port "
                 "serves lockstep batches on one card")
    if args.prompt_len < 1 or args.gen < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen must be >= 1")
    if args.temperature <= 0:
        ap.error("--temperature must be > 0")
    return args


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lockstep_decode(cfg, params, *, batch: int, prompt_len: int, gen: int,
                    temperature: float, device) -> dict:
    """Decode ``batch`` random prompts (numpy seed 0) in lockstep on
    ``params``' device: one prompt token per step, then ``gen`` tokens
    sampled from ``softmax(logits / T)``.  Returns the timing and the
    (T, B) token array."""
    from repro_torch.runtime.serve import build_serve_step, prepare_serve_states

    cache_len = prompt_len + gen
    ss = build_serve_step(cfg, batch_global=batch, cache_len=cache_len)
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
            "tok_per_s": gen_tokens / dt}


def main(argv=None) -> dict:
    """Run the launcher; returns the timing and the (T, B) token array."""
    args = _parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card found: the port serves on the card; "
                         "pass --device cpu to run the plain versions on the CPU")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.mesh import SINGLE
    from repro_torch.models.model import init_model

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cache_len = args.prompt_len + args.gen
    dev_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} serve plan: stage={SINGLE.stage} tp={SINGLE.tp} "
          f"cache={cache_len} device={dev_name}")

    params = init_model(torch.Generator(device=device).manual_seed(0), cfg, device)
    res = lockstep_decode(cfg, params, batch=args.batch, prompt_len=args.prompt_len,
                          gen=args.gen, temperature=args.temperature, device=device)
    dt, steps = res["seconds"], res["steps"]
    print(f"decoded {args.gen} steps x batch {args.batch} in {dt:.3f}s "
          f"({res['tok_per_s']:.1f} tok/s on {dev_name}; "
          f"{steps} decode steps, {dt / steps * 1e3:.3f} ms/step)")
    print("sample sequence 0:", res["tokens"][:24, 0], "...")
    print("done")
    return {**res, "device": dev_name}


if __name__ == "__main__":
    main()
