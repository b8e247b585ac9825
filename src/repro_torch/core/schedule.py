"""Pipeline schedule arithmetic (from ``repro.core.schedule``, framework-free).

Only the synchronous scan's tick count so far; the 1F1B and two-stream op
orders come with the planner-driven path.
"""


def scan_ticks(P: int, M: int) -> int:
    """Forward-scan length of the synchronous runtime pipeline: M
    micro-batches through P stages take M + P - 1 ticks."""
    return M + P - 1
