"""Continuous batching: slot-based decode with admit/retire.

A copy of ``repro.runtime.continuous``.  The engine owns a fixed set of
decode *slots* (rows of the padded per-shard batch a
``build_slot_serve_step`` step decodes).  Requests queue on arrival, are
admitted into free slots (resetting that row's state), decode one token per
engine step at their own per-row position, and retire on completion: no
lockstep batch boundaries, so a long request never stalls the batch behind
it.

Determinism contract: a sampled token depends only on ``(seed,
request_id, position)`` and that row's logits, and decode is
row-independent, so the generated text is the same whatever the arrival
timing, admission order, or slot a request lands in.  MoE capacity routing
is the one documented exception, as in ``repro``: an MoE layer routes the
rows of a token set together (one data shard's rows of one decode group in
``build_slot_serve_step``, every row in ``engine_from_decode_step``), and
where an expert's buffer overflows, which pairs drop depends on the other
rows of the set, padded and idle rows included.  Where nothing drops (a
capacity factor large enough), the contract holds for MoE configs too.
``repro`` samples
with ``fold_in(fold_in(key, rid), pos)`` and ``jax.random.categorical``;
the port cannot draw JAX's numbers, so its draws differ (as the lockstep
launcher's do): a fixed mixing function of ``(seed, rid, pos)`` seeds a CPU
``torch.Generator``, and ``torch.multinomial`` draws from the softmax of
the raw logits (no temperature, as in ``repro``).

The clock is injectable: the launcher uses the real ``perf_counter`` to
measure step time (the engines return host logits, and that copy waits for
the card), tests use a fake timer, and arrivals are replayed on the same
simulated clock either way (open-loop: the arrival process does not slow
down when the server falls behind).  As in ``repro``, the clock advances by
the engine call alone; with ``draws_on_clock`` it advances by the call and
the host draws that follow it, the time a client of the server waits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    arrival: float             # seconds on the open-loop clock
    prompt_token: int          # synthetic single-token prompt (decode-only)
    n_tokens: int              # tokens to generate


@dataclasses.dataclass
class Completion:
    rid: int
    arrival: float
    finish: float
    tokens: list[int]
    token_latencies: list[float]   # completion clock - ready clock, per token

    @property
    def latency(self) -> float:
        return self.finish - self.arrival


def poisson_requests(rate: float, horizon: float, *, n_tokens: int,
                     seed: int = 0, vocab: int = 256) -> list[Request]:
    """Open-loop Poisson arrival process at ``rate`` requests/s for
    ``horizon`` seconds of simulated time (numpy's ``RandomState``, so the
    same requests as ``repro``'s)."""
    rng = np.random.RandomState(seed)
    out, t, rid = [], 0.0, 0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= horizon:
            return out
        out.append(Request(rid=rid, arrival=t,
                           prompt_token=int(rng.randint(vocab)),
                           n_tokens=n_tokens))
        rid += 1


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def sample_seed(seed: int, rid: int, pos: int) -> int:
    """The generator seed of token ``pos`` of request ``rid``: splitmix64
    folded over the three integers (the ``fold_in`` chain's counterpart)."""
    h = _splitmix64(seed & _MASK64)
    h = _splitmix64(h ^ (rid & _MASK64))
    return _splitmix64(h ^ (pos & _MASK64))


def sample_token(logits_row, seed: int, rid: int, pos: int) -> int:
    """Draw one token from ``softmax(logits_row)`` with the generator that
    ``(seed, rid, pos)`` alone seeds."""
    gen = torch.Generator().manual_seed(sample_seed(seed, rid, pos))
    row = torch.as_tensor(np.asarray(logits_row, np.float32))
    return int(torch.multinomial(torch.softmax(row, -1), 1, generator=gen))


@dataclasses.dataclass
class _Slot:
    rid: int = -1
    pos: int = 0
    remaining: int = 0
    next_token: int = 0
    ready: float = 0.0         # clock at which the next token became due
    fresh: bool = False        # admitted since the last engine step


class ContinuousBatcher:
    """Host-side admit/decode/retire loop over a per-slot decode step.

    ``step``: callable ``(tokens (B,), positions (B,), reset (B,)) ->
    logits (B, V)`` on numpy arrays, over the full padded batch (see
    ``engine_from_serve_step`` / ``engine_from_decode_step``).  ``slots``
    lists the live row indices; for a planner split this is
    ``slot_rows(shard_alloc)``.  Padded rows are never admitted into.
    ``step_seconds`` holds each engine call's time; with ``draws_on_clock``
    the clock also advances by each step's host draws, ``draw_seconds``.
    """

    def __init__(self, step: Callable, *, slots: Sequence[int], batch: int,
                 cache_len: int, seed: int = 0,
                 timer: Callable[[], float] | None = None,
                 draws_on_clock: bool = False):
        self.step = step
        self.slot_rows = list(slots)
        self.batch = batch
        self.cache_len = cache_len
        self.seed = seed
        self.timer = timer or time.perf_counter
        self.free = list(self.slot_rows)
        self.active: dict[int, _Slot] = {}
        self.clock = 0.0
        self.steps = 0
        self.step_seconds: list[float] = []
        self.draws_on_clock = draws_on_clock
        self.draw_seconds: list[float] = []

    # -- scheduling --------------------------------------------------------

    def _admit(self, queue: list[Request]):
        while queue and self.free:
            req = queue.pop(0)
            row = self.free.pop(0)
            self.active[row] = _Slot(
                rid=req.rid, pos=0,
                remaining=min(req.n_tokens, self.cache_len),
                next_token=req.prompt_token, ready=max(req.arrival, self.clock),
                fresh=True)

    def _sample(self, logits_row: np.ndarray, rid: int, pos: int) -> int:
        return sample_token(logits_row, self.seed, rid, pos)

    # -- main loop ---------------------------------------------------------

    def run(self, requests: Sequence[Request],
            max_steps: int | None = None) -> list[Completion]:
        """Serve ``requests`` (sorted by arrival) to completion."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        queue: list[Request] = []
        done: dict[int, Completion] = {
            r.rid: Completion(r.rid, r.arrival, 0.0, [], []) for r in pending}
        tokens = np.zeros(self.batch, np.int32)
        positions = np.zeros(self.batch, np.int32)
        reset = np.zeros(self.batch, bool)

        while pending or queue or self.active:
            if max_steps is not None and self.steps >= max_steps:
                break
            # open-loop arrivals up to the current clock; if the server is
            # idle, fast-forward to the next arrival
            if not queue and not self.active and pending:
                self.clock = max(self.clock, pending[0].arrival)
            while pending and pending[0].arrival <= self.clock:
                queue.append(pending.pop(0))
            self._admit(queue)
            if not self.active:
                continue

            reset[:] = False
            for row, sl in self.active.items():
                tokens[row] = sl.next_token
                positions[row] = sl.pos
                reset[row] = sl.fresh
                sl.fresh = False
            t0 = self.timer()
            logits = np.asarray(self.step(tokens, positions, reset))
            t1 = self.timer()
            drawn = {row: self._sample(logits[row], sl.rid, sl.pos)
                     for row, sl in self.active.items()}
            self.step_seconds.append(t1 - t0)
            if self.draws_on_clock:
                t2 = self.timer()
                self.draw_seconds.append(t2 - t1)
                t1 = t2
            self.clock += t1 - t0
            self.steps += 1

            for row in list(self.active):
                sl = self.active[row]
                tok = drawn[row]
                comp = done[sl.rid]
                comp.tokens.append(tok)
                comp.token_latencies.append(self.clock - sl.ready)
                sl.ready = self.clock
                sl.next_token = tok
                sl.pos += 1
                sl.remaining -= 1
                if sl.remaining <= 0 or sl.pos >= self.cache_len:
                    comp.finish = self.clock
                    del self.active[row]
                    self.free.append(row)
        return [done[r.rid] for r in sorted(requests, key=lambda r: r.rid)
                if done[r.rid].tokens]


def slot_rows(shard_alloc: Sequence[int]) -> list[int]:
    """Live row indices of the padded shard-major batch layout
    (``build_slot_serve_step``): rows ``[d*B_max, d*B_max + alloc[d])``."""
    b_max = max(shard_alloc)
    rows = []
    for d, y in enumerate(shard_alloc):
        rows.extend(range(d * b_max, d * b_max + y))
    return rows


def _to_device(tokens, positions, device):
    """The step's row arrays on ``device``, int32.  The reset mask stays on
    the host: only the in-place zeroing reads it."""
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    return as_t(tokens), as_t(positions)


def engine_from_serve_step(ss, params, device="cuda"):
    """Adapt a ``build_slot_serve_step`` ServeStep into the batcher's step
    callable.  It owns the decode state tree across calls (on ``device``,
    where ``params`` live; ``step.holder["states"]``).  Each call sends the
    tokens and positions to the device, zeroes the admitted rows' states in
    place (their indices from the host mask), decodes, and returns the
    logits as a host array: that copy waits for the card."""
    from .serve import prepare_serve_states

    spec = ss.spec
    holder = {"states": prepare_serve_states(spec.cfg, spec.plan, spec.batch_global,
                                             spec.cache_len, device)}

    def step(tokens, positions, reset):
        tok, pos = _to_device(tokens, positions, device)
        logits, holder["states"] = ss.step_fn(params, tok, pos, reset, holder["states"])
        return logits.cpu().numpy()

    step.holder = holder
    return step


def engine_from_decode_step(params, cfg, *, batch: int, cache_len: int,
                            device="cuda"):
    """Single-device engine over ``models.model.decode_step``: the mesh-free
    path, no padded rows, with the same in-place reset (states on
    ``device``, where ``params`` live; ``step.holder["states"]``).  An MoE
    layer routes all rows as one token set, as ``repro``'s does."""
    from repro_torch.models.model import decode_step, init_decode_states

    from .serve import zero_rows

    holder = {"states": init_decode_states(batch, cache_len, cfg, device)}

    @torch.inference_mode()
    def step(tokens, positions, reset):
        tok, pos = _to_device(tokens, positions, device)
        zero_rows(holder["states"], np.flatnonzero(reset).tolist())
        logits, holder["states"] = decode_step(params, tok, pos, holder["states"], cfg)
        return logits.cpu().numpy()

    step.holder = holder
    return step
