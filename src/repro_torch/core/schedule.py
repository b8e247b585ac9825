"""Micro-batch schedules: memory-efficient 1F1B with per-stage warm-up K_p.

The paper's §3.2: GPipe runs all M forwards then all backwards, so peak
activation memory scales O(M).  Asteroid performs ``K_p`` forwards on stage
p before strictly alternating one-forward-one-backward, bounding resident
activations to O(K_p) with ``K_p = 2*(P-p)-1`` chosen so parallelism is not
sacrificed (Fig. 15b compares the neighboring policies).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from .costmodel import kp_policy


@dataclasses.dataclass(frozen=True)
class Op:
    kind: str          # 'F' | 'B' (compute stream) | 'S' | 'R' | 'A' (comm)
    micro: int


def stage_order_1f1b(M: int, k_p: int) -> tuple[Op, ...]:
    """Op order for one stage under 1F1B with warm-up depth k_p."""
    k = max(1, min(k_p, M))
    ops: list[Op] = [Op("F", m) for m in range(k)]
    nf, nb = k, 0
    while nb < M:
        ops.append(Op("B", nb))
        nb += 1
        if nf < M:
            ops.append(Op("F", nf))
            nf += 1
    return tuple(ops)


def stage_order_gpipe(M: int) -> tuple[Op, ...]:
    return tuple([Op("F", m) for m in range(M)] + [Op("B", m) for m in range(M)])


def schedule_orders(P: int, M: int, policy: str = "ours") -> list[tuple[Op, ...]]:
    """Per-stage op orders for a P-stage pipeline.

    policy in {'ours', 'a', 'b', 'c'} selects the K_p formula (Fig. 15b);
    'gpipe' is backward-after-forward.
    """
    if policy == "gpipe":
        return [stage_order_gpipe(M) for _ in range(P)]
    return [stage_order_1f1b(M, kp_policy(P, p, policy)) for p in range(P)]


def max_inflight(order: tuple[Op, ...]) -> int:
    """Peak number of micro-batches whose activations are resident."""
    live = 0
    peak = 0
    for op in order:
        live += 1 if op.kind == "F" else -1
        peak = max(peak, live)
    return peak


# ---------------------------------------------------------------------------
# Async (two-stream) schedule enumeration
# ---------------------------------------------------------------------------
#
# The overlapped runtime splits every stage into a compute stream (the F/B
# order above, unchanged — overlap never reorders compute) and a comm
# stream: per forward an activation send 'S' to stage p+1, per backward a
# gradient send 'R' to stage p-1, each launched one compute slot after the
# op that produced it (the double buffer), plus — under staleness >= 1 — a
# trailing 'A' (gradient AllReduce) that drains during the next round's
# warm-up forwards instead of extending this round.


def comm_stream(order: tuple[Op, ...], p: int, P: int,
                staleness: int = 1) -> tuple[Op, ...]:
    """Comm-stream op order for stage p given its compute order.

    'S m' follows F(m) for every non-last stage, 'R m' follows B(m) for
    every non-first stage — in compute completion order, which is the order
    the double buffer hands transfers to the link.  With ``staleness >= 1``
    a terminal 'A' marks the overlapped gradient AllReduce; with
    ``staleness == 0`` the AllReduce is synchronous (it lives in the round
    boundary, not on the overlapped stream) and is omitted here.
    """
    ops: list[Op] = []
    for op in order:
        if op.kind == "F" and p < P - 1:
            ops.append(Op("S", op.micro))
        elif op.kind == "B" and p > 0:
            ops.append(Op("R", op.micro))
    if staleness >= 1:
        ops.append(Op("A", -1))
    return tuple(ops)


def two_stream_orders(P: int, M: int, policy: str = "ours",
                      staleness: int = 1):
    """Per-stage (compute, comm) op orders for the overlapped pipeline.

    Returns ``(compute_orders, comm_orders)``; ``compute_orders`` is
    exactly ``schedule_orders(P, M, policy)`` (overlap moves transfers to
    a second stream, it does not re-schedule compute), and
    ``comm_orders[p]`` is stage p's comm stream (``comm_stream``).
    """
    compute = schedule_orders(P, M, policy)
    comm = [comm_stream(compute[p], p, P, staleness) for p in range(P)]
    return compute, comm


def scan_ticks(P: int, M: int, double_buffer: bool = False) -> int:
    """Forward-scan length of the runtime pipeline: the double-buffered
    variant pays a 2-tick stage hop (compute tick + in-flight tick) for
    the overlap, so warm-up doubles while steady state is unchanged."""
    return M + (2 * (P - 1) if double_buffer else (P - 1))
