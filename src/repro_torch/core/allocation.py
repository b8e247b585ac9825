"""Algorithm 1: allocation of a micro-batch's samples across a device group.

Phase 1 — MemoryAwareBalancing: recursively split the micro-batch in
proportion to device computing capacity v_d (Eq. 9), capping each device at
the largest batch its memory budget admits (Eq. 3), and re-distributing the
unallocated remainder among devices with memory left.

Phase 2 — StragglerWorkloadOffloading: because time-vs-batch is non-linear
(Fig. 6), proportional allocation is suboptimal; iteratively move one block
of samples from the straggler to the fastest device with spare memory until
the straggler stops improving.
"""

from __future__ import annotations

import dataclasses

from .costmodel import stage_memory
from .profiler import Profile


class AllocationError(RuntimeError):
    """Group cannot host the stage within memory budgets (T = inf)."""


@dataclasses.dataclass(frozen=True)
class Allocation:
    y: tuple[int, ...]            # samples per device (group order)
    ef: float                     # Eq. 8: max_d fwd time
    eb: float                     # Eq. 8: max_d bwd time

    @property
    def t(self) -> float:
        return self.ef + self.eb


def _max_batch_under_budget(profile: Profile, dev_rank: int, i: int, j: int,
                            k_p: int, micro_batch: int) -> int:
    """Largest beta with Mem(beta) <= u_d (binary search; Eq. 3 is monotone)."""
    dev = profile.cluster.devices[dev_rank]
    lo, hi = 0, micro_batch
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if stage_memory(profile.table, i, j, mid, k_p) <= dev.mem_bytes:
            lo = mid
        else:
            hi = mid - 1
    return lo


def allocate_microbatch(profile: Profile, group: tuple[int, ...], micro_batch: int,
                        i: int, j: int, k_p: int, block: int = 1,
                        offload: bool = True) -> Allocation:
    """Run Algorithm 1 for stage layers [i, j) on ``group`` device ranks.

    ``offload=False`` disables Phase 2 (the ablation in Fig. 15a)."""
    cluster = profile.cluster
    caps = {d: _max_batch_under_budget(profile, d, i, j, k_p, micro_batch)
            for d in group}

    # Eq. 9: capacity = inverse of full-micro-batch fwd+bwd latency
    v = {d: 1.0 / max(profile.t_both(d, micro_batch, i, j), 1e-12) for d in group}

    y = {d: 0 for d in group}

    # ---- Phase 1: MemoryAwareBalancing (recursive) ----------------------
    def balance(g: list[int], beta: int):
        if beta == 0:
            return
        if not g:
            raise AllocationError(f"stage [{i},{j}) needs {beta} more samples "
                                  f"but no device has memory left")
        vsum = sum(v[d] for d in g)
        # proportional share, floored; remainder goes to the fastest devices
        shares = {d: int(v[d] / vsum * beta) for d in g}
        rem = beta - sum(shares.values())
        for d in sorted(g, key=lambda d: -v[d]):
            if rem == 0:
                break
            shares[d] += 1
            rem -= 1
        leftover = 0
        for d in g:
            take = min(shares[d], caps[d] - y[d])
            y[d] += take
            leftover += shares[d] - take
        g2 = [d for d in g if y[d] < caps[d]]
        if leftover:
            balance(g2, leftover)

    balance(list(group), micro_batch)

    # ---- Phase 2: StragglerWorkloadOffloading ---------------------------
    def lat(d: int) -> float:
        return profile.t_both(d, y[d], i, j)

    while offload:
        order = sorted(group, key=lat)
        straggler = order[-1]
        old = lat(straggler)
        moved = False
        for fast in order[:-1]:
            if y[fast] + block <= caps[fast] and y[straggler] >= block:
                y[fast] += block
                y[straggler] -= block
                new_straggler = max(group, key=lat)
                if lat(new_straggler) < old:
                    moved = True
                    break
                y[fast] -= block          # revert: offload made things worse
                y[straggler] += block
        if not moved:
            break

    ef = max(profile.t_fwd(d, y[d], i, j) for d in group)
    eb = max(profile.t_bwd(d, y[d], i, j) for d in group)
    return Allocation(tuple(y[d] for d in group), ef, eb)
