"""Device and link models for the Asteroid planner.

The paper profiles real Jetson boards; we model each device with a peak
compute rate plus a *non-linear batch-efficiency curve* (the paper's Fig. 6
observation: small batches underutilize the GPU, so time-vs-batch is not
linear).  ``eff(beta) = beta / (beta + k)`` saturates with half-saturation
``k`` — larger accelerators have larger ``k``.

All times are seconds, sizes bytes, rates FLOP/s and bytes/s.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    mem_bytes: float           # memory budget u_d
    flops: float               # datasheet peak (fp16/bf16 training mix)
    sat_batch: float = 8.0     # half-saturation batch size k (Fig. 6 shape)
    sat_flops: float = 1e9     # half-saturation work per kernel launch:
                               # small convolutions badly underutilize wide
                               # accelerators (the second non-linearity the
                               # paper's profiler captures)
    overhead: float = 3e-4     # fixed per-layer launch overhead (s)

    def eff(self, beta: float) -> float:
        return beta / (beta + self.sat_batch)

    def eff_size(self, flops_per_sample: float) -> float:
        # per-sample (batch-independent) so layer_time stays monotone in beta
        return flops_per_sample / (flops_per_sample + self.sat_flops)

    def layer_time(self, flops_per_sample: float, beta: float) -> float:
        """Execution time of one layer pass at batch size beta (monotone
        non-decreasing in beta; per-sample time non-increasing — Fig. 6)."""
        if beta <= 0:
            return 0.0
        work = flops_per_sample * beta
        return work / (self.flops * self.eff(beta) *
                       self.eff_size(flops_per_sample)) + self.overhead


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

# Constants calibrated against the paper's Table 1 epoch times (grid fit,
# max log-error <= 0.21 across all nine (model, device) pairs): small-conv
# training on Jetsons runs far below datasheet peak, captured by sat_flops.
JETSON_NANO = DeviceProfile("nano", mem_bytes=4e9, flops=1.0e11, sat_batch=8,
                            sat_flops=3.7e7, overhead=3e-4)
JETSON_TX2 = DeviceProfile("tx2", mem_bytes=8e9, flops=4.0e11, sat_batch=12,
                           sat_flops=6.9e7, overhead=5e-4)
JETSON_NX = DeviceProfile("nx", mem_bytes=8e9, flops=1.0e12, sat_batch=16,
                          sat_flops=9e7, overhead=4e-4)
A100 = DeviceProfile("a100", mem_bytes=40e9, flops=2.0e13, sat_batch=64,
                     sat_flops=2e7, overhead=1e-4)

# TPU v5e chip (production target; constants from the assignment)
TPU_V5E = DeviceProfile("v5e", mem_bytes=16e9, flops=1.97e14, sat_batch=64,
                        sat_flops=3e7, overhead=2e-5)
TPU_V5E_HBM_BW = 819e9        # bytes/s
TPU_V5E_ICI_BW = 50e9         # bytes/s per link

MBPS_100 = 100e6 / 8          # paper's two D2D settings
MBPS_1000 = 1000e6 / 8


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A pool of devices with a uniform (or matrix) D2D bandwidth."""

    devices: tuple[DeviceProfile, ...]
    bandwidth: float = MBPS_100            # uniform D2D bytes/s
    bw_matrix: tuple[tuple[float, ...], ...] | None = None

    def bw(self, i: int, j: int) -> float:
        if self.bw_matrix is not None:
            return self.bw_matrix[i][j]
        return self.bandwidth

    def min_bw(self, ranks) -> float:
        ranks = list(ranks)
        if len(ranks) < 2:
            return self.bandwidth
        return min(self.bw(i, j) for i in ranks for j in ranks if i != j)

    def sorted_by_memory(self) -> "Cluster":
        """Planner preprocessing: descending memory (earlier stages get more)."""
        order = sorted(range(len(self.devices)),
                       key=lambda i: (-self.devices[i].mem_bytes, -self.devices[i].flops))
        return Cluster(tuple(self.devices[i] for i in order), self.bandwidth,
                       self.bw_matrix)


# Paper testbeds (Table 6)
def env_a() -> Cluster:
    return Cluster((JETSON_NANO,) * 5)


def env_b(bw: float = MBPS_100) -> Cluster:
    return Cluster((JETSON_NX,) * 3 + (JETSON_TX2,) * 2, bandwidth=bw)


def env_c() -> Cluster:
    return Cluster((JETSON_NX,) + (JETSON_TX2,) * 2 + (JETSON_NANO,) * 3)


def env_d() -> Cluster:
    return Cluster((JETSON_TX2,) + (JETSON_NANO,) * 3)


ENVS = {"A": env_a, "B": env_b, "C": env_c, "D": env_d}
