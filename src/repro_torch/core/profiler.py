"""Asteroid Profiler (§3.3): per-layer sizes and per-(device, batch) times.

Three construction paths:

* ``LayerTable.from_model_config`` — analytic per-layer FLOPs/bytes derived
  from a ``repro_torch.models.config.ModelConfig``, plus hand-built tables
  for the paper's CNNs (``configs/paper_models.py``).
* ``measure_layer_times`` — a *real* profiler that runs torch layer
  functions on the card (or the CPU, in tests) across a batch-size sweep.
* ``MeasuredProfile`` — the serializable artifact produced by
  ``repro_torch.launch.profile``: raw measured ``(tf, tb)`` sweeps per device plus
  the cluster/config fingerprints needed to decide whether the measurement
  is still valid.  ``save_profile``/``load_profile`` round-trip it through
  versioned JSON bit-exactly; ``MeasuredProfile.to_profile`` densifies the
  sweeps into ``Profile.measured`` tables for the planner.

The planner consumes a ``Profile``: cumulative per-layer time tables
``t_f/t_b [device][beta][layer]`` with prefix sums so any layer-range cost
is O(1).  ``Profile.source`` records which path built it ("analytic" or
"measured") so downstream reporting can attribute prediction error to
the profile.

A copy of ``repro.core.profiler`` with the same ``asteroid-profile`` v1
JSON schema, so an artifact written by either package loads in the other.
Its fingerprints differ by design: ``config_fingerprint`` hashes the port's
``ModelConfig``, which has fewer fields than ``repro``'s, and
``device_fingerprint`` hashes the torch device, so each package treats the
other's artifact as stale and plans on the analytic profile instead.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Callable, Sequence

import numpy as np

from .hardware import MBPS_1000, Cluster, DeviceProfile

BWD_FLOP_RATIO = 2.0           # backward ~= 2x forward FLOPs
GRAD_BYTES = 4                 # accumulated grads fp32
PARAM_BYTES = 4
ACT_BYTES = 4

PROFILE_SCHEMA = "asteroid-profile"
PROFILE_VERSION = 1


class ProfileError(ValueError):
    """A profile artifact or sample table is malformed or incompatible."""


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Static per-layer facts (per *sample* where applicable)."""

    name: str
    flops_fwd: float           # per sample
    param_bytes: float         # w_l
    act_bytes: float           # a_l — output activation per sample (the
                               # tensor crossing a stage boundary after l)


@dataclasses.dataclass(frozen=True)
class LayerTable:
    """The profiled DNN as a topologically-sorted layer sequence."""

    name: str
    layers: tuple[LayerCost, ...]

    @property
    def L(self) -> int:
        return len(self.layers)

    def param_bytes(self, i: int, j: int) -> float:
        return sum(l.param_bytes for l in self.layers[i:j])

    def act_bytes_sum(self, i: int, j: int) -> float:
        return sum(l.act_bytes for l in self.layers[i:j])

    def boundary_act(self, j: int) -> float:
        """Activation size crossing the boundary after layer j-1."""
        return self.layers[j - 1].act_bytes if 0 < j <= self.L else 0.0

    def flops(self, i: int, j: int) -> float:
        return sum(l.flops_fwd for l in self.layers[i:j])

    # ------------------------------------------------------------------
    @staticmethod
    def from_model_config(cfg, seq_len: int) -> "LayerTable":
        """Analytic table for a transformer ModelConfig (per-sample costs).

        One entry per LayerSpec instance plus embed/head pseudo-layers.
        """
        d, S = cfg.d_model, seq_len
        layers = [LayerCost("embed", 2 * d * S, cfg.vocab_size * d * PARAM_BYTES,
                            S * d * ACT_BYTES)]
        for li in range(cfg.n_layers):
            spec = cfg.pattern[li % len(cfg.pattern)]
            p_count = cfg.layer_param_count(spec)
            p_active = cfg.layer_active_param_count(spec)
            flops = 2.0 * p_active * S
            if spec.kind == "attn" and cfg.attn is not None:
                a = cfg.attn
                win = spec.window if not spec.full_attention else None
                eff_ctx = S if win is None else min(S, win)
                flops += 2.0 * 2.0 * S * eff_ctx * a.n_heads * a.head_dim / 2.0
            act = S * d * ACT_BYTES
            layers.append(LayerCost(f"{spec.kind}{li}", flops,
                                    p_count * PARAM_BYTES, act))
        layers.append(LayerCost("head", 2 * d * cfg.vocab_size * S,
                                (0 if cfg.tie_embeddings else cfg.vocab_size * d * PARAM_BYTES),
                                S * cfg.vocab_size * ACT_BYTES))
        return LayerTable(cfg.name, tuple(layers))


@dataclasses.dataclass
class Profile:
    """Planner input: time tables + sizes.  Times indexed [dev][beta][layer]
    as *cumulative* sums over layers (prefix[l] = sum of layers < l)."""

    table: LayerTable
    cluster: Cluster
    max_batch: int
    tf_prefix: np.ndarray      # (D, max_batch+1, L+1)
    tb_prefix: np.ndarray
    source: str = "analytic"   # "analytic" | "measured" (provenance only)

    # -- range queries ---------------------------------------------------
    def t_fwd(self, dev: int, beta: int, i: int, j: int) -> float:
        if beta <= 0:
            return 0.0
        beta = min(beta, self.max_batch)
        return float(self.tf_prefix[dev, beta, j] - self.tf_prefix[dev, beta, i])

    def t_bwd(self, dev: int, beta: int, i: int, j: int) -> float:
        if beta <= 0:
            return 0.0
        beta = min(beta, self.max_batch)
        return float(self.tb_prefix[dev, beta, j] - self.tb_prefix[dev, beta, i])

    def t_both(self, dev: int, beta: int, i: int, j: int) -> float:
        return self.t_fwd(dev, beta, i, j) + self.t_bwd(dev, beta, i, j)

    # ------------------------------------------------------------------
    @staticmethod
    def analytic(table: LayerTable, cluster: Cluster, max_batch: int) -> "Profile":
        D, L = len(cluster.devices), table.L
        tf = np.zeros((D, max_batch + 1, L + 1))
        tb = np.zeros((D, max_batch + 1, L + 1))
        for di, dev in enumerate(cluster.devices):
            f, b = analytic_layer_times(dev, table, max_batch)
            tf[di, :, 1:] = np.cumsum(f, axis=1)
            tb[di, :, 1:] = np.cumsum(b, axis=1)
        return Profile(table, cluster, max_batch, tf, tb)

    @staticmethod
    def measured(table: LayerTable, cluster: Cluster, max_batch: int,
                 tf_samples: np.ndarray, tb_samples: np.ndarray) -> "Profile":
        """From measured per-layer times: samples (D, max_batch+1, L).

        Every device's table must cover every batch size up to ``max_batch``
        (row ``beta`` holds the per-layer times at batch ``beta``; row 0 is
        zero).  A shape mismatch raises ``ProfileError`` up front instead of
        the planner later hitting a silent out-of-range index/broadcast
        fault mid-DP.
        """
        D, L = len(cluster.devices), table.L
        want = (D, max_batch + 1, L)
        arrs = []
        for name, s in (("tf_samples", tf_samples), ("tb_samples", tb_samples)):
            s = np.asarray(s, dtype=np.float64)
            if s.shape != want:
                raise ProfileError(
                    f"{name} shape {s.shape} does not cover the profile: "
                    f"need (devices={D}, batch rows=max_batch+1={max_batch + 1}, "
                    f"layers={L}) — every device's sample table must cover "
                    f"batch sizes 0..{max_batch} for all {L} layers of "
                    f"{table.name!r}")
            if not np.isfinite(s).all() or (s < 0).any():
                raise ProfileError(
                    f"{name} contains negative or non-finite layer times")
            zero = np.argwhere(s[:, 1:, :].sum(axis=2) == 0.0)
            if zero.size:
                d, b = (int(x) for x in zero[0])
                raise ProfileError(
                    f"{name} has a zero measured-time row: device {d} at "
                    f"batch {b + 1} totals 0s across all {L} layers — an "
                    f"all-zero sweep row means the measurement failed for "
                    f"that (device, batch); re-profile or drop the device")
            arrs.append(s)
        tf_samples, tb_samples = arrs
        tf = np.zeros((D, max_batch + 1, L + 1))
        tb = np.zeros((D, max_batch + 1, L + 1))
        tf[:, :, 1:] = np.cumsum(tf_samples, axis=2)
        tb[:, :, 1:] = np.cumsum(tb_samples, axis=2)
        return Profile(table, cluster, max_batch, tf, tb, source="measured")


def analytic_layer_times(device: DeviceProfile, table: LayerTable,
                         max_batch: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-layer analytic ``(tf, tb)`` sample tables for one device.

    Shape ``(max_batch+1, L)`` with row 0 zero — the single-device slice of
    what ``Profile.analytic`` builds, exposed so ``extend_profile`` can
    price an unprofiled newcomer with the identical FLOP model."""
    L = table.L
    tf = np.zeros((max_batch + 1, L))
    flops = np.array([l.flops_fwd for l in table.layers])
    for beta in range(1, max_batch + 1):
        work = flops * beta
        eff = device.eff(beta) * flops / (flops + device.sat_flops)
        tf[beta] = work / (device.flops * np.maximum(eff, 1e-9)) + device.overhead
    return tf, tf * BWD_FLOP_RATIO


def extend_profile(profile: Profile, device: DeviceProfile,
                   tf_samples: np.ndarray | None = None,
                   tb_samples: np.ndarray | None = None, *,
                   bw: float | None = None) -> Profile:
    """Append one device to ``profile`` as the LAST cluster rank.

    The scale-out half of elastic membership
    (``core.replay.admission_replay``): incumbent devices keep their ranks —
    the running plan and the migration accounting stay addressable by the
    same device identities — and the newcomer becomes rank ``D``.

    ``tf_samples``/``tb_samples``: the newcomer's per-layer time tables of
    shape ``(max_batch+1, L)`` with row 0 zero, e.g. its measured on-arrival
    sweep densified by ``MeasuredProfile.device_rows``.  Omitted, the
    analytic FLOP model of ``device`` fills the row (the fallback when a
    newcomer arrives unprofiled).

    ``bw``: D2D bandwidth between the newcomer and every incumbent when the
    cluster prices links through a ``bw_matrix`` (defaults to the
    cluster-wide bandwidth)."""
    table, mb = profile.table, profile.max_batch
    D, L = len(profile.cluster.devices), table.L
    measured_row = tf_samples is not None and tb_samples is not None
    if (tf_samples is None) != (tb_samples is None):
        raise ProfileError(
            "pass both tf_samples and tb_samples, or neither")
    if not measured_row:
        tf_samples, tb_samples = analytic_layer_times(device, table, mb)
    arrs = []
    for name, s in (("tf_samples", tf_samples), ("tb_samples", tb_samples)):
        s = np.asarray(s, dtype=np.float64)
        if s.shape != (mb + 1, L):
            raise ProfileError(
                f"{name} shape {s.shape} != {(mb + 1, L)}: the newcomer's "
                f"table must cover batch sizes 0..{mb} for all {L} layers "
                f"of {table.name!r}")
        if not np.isfinite(s).all() or (s < 0).any():
            raise ProfileError(
                f"{name} contains negative or non-finite layer times")
        arrs.append(s)
    tf_samples, tb_samples = arrs
    tfp = np.zeros((D + 1, mb + 1, L + 1))
    tbp = np.zeros((D + 1, mb + 1, L + 1))
    tfp[:D], tbp[:D] = profile.tf_prefix, profile.tb_prefix
    tfp[D, :, 1:] = np.cumsum(tf_samples, axis=1)
    tbp[D, :, 1:] = np.cumsum(tb_samples, axis=1)
    bwm = profile.cluster.bw_matrix
    if bwm is not None:
        link = bw if bw is not None else profile.cluster.bandwidth
        bwm = tuple(tuple(row) + (link,) for row in bwm) \
            + (tuple([link] * D + [0.0]),)
    cluster = Cluster(profile.cluster.devices + (device,),
                      profile.cluster.bandwidth, bwm)
    source = profile.source
    if measured_row and source == "analytic":
        source = "mixed"
    elif not measured_row and source == "measured":
        source = "mixed"
    return Profile(table, cluster, mb, tfp, tbp, source)


def subset_profile(profile: Profile, ranks: Sequence[int]) -> Profile:
    """``profile`` restricted to cluster ranks ``ranks`` (order preserved).

    The post-churn planning view: after failures/evictions the session's
    profile still carries every original device, but a portfolio auction
    must only enumerate plans over the survivors.  Device ``i`` of the
    returned profile is original rank ``ranks[i]``; use
    ``portfolio.renumber_plan(plan, ranks)`` to map a plan made on the
    subset back into the parent cluster's numbering."""
    ranks = tuple(int(r) for r in ranks)
    D = len(profile.cluster.devices)
    if not ranks or len(set(ranks)) != len(ranks) or \
            any(not 0 <= r < D for r in ranks):
        raise ProfileError(
            f"ranks {ranks} must be distinct indices into 0..{D - 1}")
    bwm = profile.cluster.bw_matrix
    if bwm is not None:
        bwm = tuple(tuple(bwm[a][b] for b in ranks) for a in ranks)
    cluster = Cluster(tuple(profile.cluster.devices[r] for r in ranks),
                      profile.cluster.bandwidth, bwm)
    idx = np.asarray(ranks)
    return Profile(profile.table, cluster, profile.max_batch,
                   profile.tf_prefix[idx], profile.tb_prefix[idx],
                   profile.source)


def resolve_profile(measured, cfg, seq_len: int, table: LayerTable,
                    max_batch: int, *, label: str = "measured profile",
                    fallback_note: str = "", device=None) -> Profile | None:
    """Turn a loaded ``MeasuredProfile`` into a planner ``Profile``, or
    ``None`` (with a warning) when it no longer describes this run.

    The stale-artifact policy in one place: fingerprint mismatches and
    densification errors degrade to the analytic fallback with a warning —
    never a crash — because a stale measurement is an expected state (model
    edited, different host), not a bug."""
    import warnings

    if measured is None:
        return None
    issues = measured.compatibility_issues(cfg, seq_len, device=device)
    prof = None
    if not issues:
        try:
            prof = measured.to_profile(table, max_batch)
        except ProfileError as e:
            issues = [str(e)]
    if prof is None:
        warnings.warn(
            f"{label} is stale or incompatible — falling back to the "
            f"analytic profile{fallback_note}: " + "; ".join(issues))
    return prof


# ---------------------------------------------------------------------------
# Real measurement path (runs on the card, or on the CPU when asked)
# ---------------------------------------------------------------------------


def _sync(x) -> None:
    import torch

    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def measure_layer_times(layer_fns: Sequence[Callable], make_input: Callable,
                        batch_sizes: Sequence[int], repeats: int = 3):
    """Measure wall-clock fwd and bwd times of each layer callable.

    layer_fns: list of x -> y functions already bound to their params.
    make_input: (beta, layer_idx) -> x, a tensor on the device to time.
    Each (layer, batch) runs once to warm up (kernel builds, allocator),
    then ``repeats`` timed calls between two ``torch.cuda.synchronize``.
    The backward is ``torch.autograd.grad(y, x, ones)`` with the weights
    not requiring grad: the input cotangent of the forward it reruns, as
    ``repro`` times ``jax.vjp(fn, x)`` over closed-over weights.  A layer
    whose input takes no gradient (the embedding's token ids) is charged
    ``BWD_FLOP_RATIO`` times its forward, as ``repro``'s fallback does.
    Returns (tf, tb) arrays of shape (len(batch_sizes), L).
    """
    import torch

    L = len(layer_fns)
    tf = np.zeros((len(batch_sizes), L))
    tb = np.zeros((len(batch_sizes), L))
    for bi, beta in enumerate(batch_sizes):
        for li, fn in enumerate(layer_fns):
            x = make_input(beta, li)
            with torch.no_grad():
                fn(x)                                # warm-up
                _sync(x)
                t0 = time.perf_counter()
                for _ in range(repeats):
                    fn(x)
                _sync(x)
            tf[bi, li] = (time.perf_counter() - t0) / repeats
            if not x.is_floating_point():
                tb[bi, li] = tf[bi, li] * BWD_FLOP_RATIO
                continue
            xg = x.detach().requires_grad_(True)

            def vjp():
                with torch.enable_grad():
                    y = fn(xg)
                    return torch.autograd.grad(y, xg, torch.ones_like(y))[0]

            vjp()                                    # warm-up
            _sync(x)
            t0 = time.perf_counter()
            for _ in range(repeats):
                vjp()
            _sync(x)
            tb[bi, li] = (time.perf_counter() - t0) / repeats
    return tf, tb


# ---------------------------------------------------------------------------
# Measured-profile artifact: fingerprints, serialization, densification
# ---------------------------------------------------------------------------


def config_fingerprint(cfg, seq_len: int) -> str:
    """Stable hash of everything that shapes the layer table.

    Covers the full ``ModelConfig`` (nested dataclasses stringified) plus
    the sequence length — a measured profile is only valid for the exact
    (model, seq_len) it profiled, because per-layer times scale with both.
    """
    blob = json.dumps({"cfg": dataclasses.asdict(cfg), "seq_len": seq_len},
                      sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def device_fingerprint(device=None) -> str:
    """Hash of the torch device the measurement would run on.

    Device type + device name + process count: enough to detect "this
    artifact was measured on different hardware", without being so strict
    that a rebuild of the same container, or splitting the card into
    *virtual* devices (``--replicate``), invalidates it.  ``device``
    defaults to the card when there is one, else the CPU.
    """
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    processes = (torch.distributed.get_world_size()
                 if torch.distributed.is_available()
                 and torch.distributed.is_initialized() else 1)
    blob = json.dumps({"platform": device.type, "device_kind": name,
                       "processes": processes}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class MeasuredProfile:
    """A measured on-device profile, as serialized by ``save_profile``.

    Holds the *raw* per-device sweeps — ``tf/tb[d, bi, l]`` is the measured
    forward/backward wall-clock of layer ``l`` on device ``d`` at batch size
    ``batch_sizes[bi]`` — plus the metadata needed to (a) rebuild a planner
    ``Profile`` (``to_profile``) and (b) decide whether the measurement
    still describes the current model and hardware
    (``compatibility_issues``).
    """

    arch: str                          # cfg.name at measurement time
    seq_len: int
    batch_sizes: tuple[int, ...]       # ascending swept batch sizes
    layer_names: tuple[str, ...]       # one per LayerTable entry
    tf: np.ndarray                     # (D, len(batch_sizes), L) seconds
    tb: np.ndarray
    device_names: tuple[str, ...]      # one per profiled (virtual) device
    config_hash: str                   # config_fingerprint(cfg, seq_len)
    device_hash: str                   # device_fingerprint() at measurement
    mem_bytes: tuple[float, ...]       # per-device memory budget u_d
    est_flops: tuple[float, ...]       # effective FLOP/s at the largest batch
    bandwidth: float = MBPS_1000       # assumed D2D bandwidth (bytes/s)
    repeats: int = 1
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = PROFILE_VERSION

    @property
    def D(self) -> int:
        return len(self.device_names)

    @property
    def L(self) -> int:
        return len(self.layer_names)

    def __post_init__(self):
        want = (self.D, len(self.batch_sizes), self.L)
        for name, a in (("tf", self.tf), ("tb", self.tb)):
            if a.shape != want:
                raise ProfileError(f"{name} shape {a.shape} != {want} "
                                   f"(devices, batch_sizes, layers)")
        if list(self.batch_sizes) != sorted(set(self.batch_sizes)) or \
                (self.batch_sizes and self.batch_sizes[0] < 1):
            raise ProfileError(
                f"batch_sizes must be ascending positive ints, got "
                f"{self.batch_sizes}")
        if len(self.mem_bytes) != self.D or len(self.est_flops) != self.D:
            raise ProfileError("per-device metadata length != device count")

    # -- planner-facing views ------------------------------------------------

    def cluster(self) -> Cluster:
        """The measured devices as a planner ``Cluster``.

        ``flops`` is the *effective* rate observed at the largest measured
        batch (not a datasheet peak), and the Fig. 6 saturation constants
        are zeroed — so ``Profile.analytic`` on this cluster is the classic
        linear FLOP model calibrated to the same hardware (total forward
        time at the calibration batch matches the measurement exactly).
        The residual error of its plans, re-priced on the measurement, is
        then precisely the per-layer / per-batch structure only a measured
        profile captures.
        """
        devs = tuple(
            DeviceProfile(name, mem_bytes=self.mem_bytes[d],
                          flops=self.est_flops[d], sat_batch=0.0,
                          sat_flops=0.0, overhead=0.0)
            for d, name in enumerate(self.device_names))
        return Cluster(devs, bandwidth=self.bandwidth)

    def densify(self, max_batch: int) -> tuple[np.ndarray, np.ndarray]:
        """Fill the swept batch sizes out to ``(D, max_batch+1, L)`` tables.

        Linear interpolation between measured batch sizes, constant
        extension below the smallest (launch overhead dominates there), and
        linear extrapolation above the largest using the last segment's
        slope.  The result is clamped non-negative and made monotone
        non-decreasing in beta, preserving the Fig. 6 shape the allocation
        search (Algorithm 1) relies on.
        """
        if max_batch < 1:
            raise ProfileError(f"max_batch must be >= 1, got {max_batch}")
        bs = np.asarray(self.batch_sizes, dtype=np.float64)
        betas = np.arange(1, max_batch + 1, dtype=np.float64)
        out = []
        for raw in (self.tf, self.tb):
            dense = np.zeros((self.D, max_batch + 1, self.L))
            for d in range(self.D):
                for l in range(self.L):
                    y = raw[d, :, l]
                    vals = np.interp(betas, bs, y)
                    if len(bs) >= 2 and max_batch > bs[-1]:
                        slope = (y[-1] - y[-2]) / (bs[-1] - bs[-2])
                        hi = betas > bs[-1]
                        vals[hi] = y[-1] + slope * (betas[hi] - bs[-1])
                    vals = np.maximum.accumulate(np.maximum(vals, 0.0))
                    dense[d, 1:, l] = vals
            out.append(dense)
        return out[0], out[1]

    def to_profile(self, table: LayerTable, max_batch: int,
                   sort_by_memory: bool = True) -> Profile:
        """Densify into a planner ``Profile`` over ``table``.

        ``sort_by_memory`` applies the planner's descending-memory device
        preorder (§3.3) to the *measured rows and the cluster together*, so
        device rank d in the returned profile is the same physical device
        in both.
        """
        if table.L != self.L or tuple(l.name for l in table.layers) != \
                self.layer_names:
            raise ProfileError(
                f"layer table {table.name!r} ({table.L} layers) does not "
                f"match the measured layers {list(self.layer_names)}")
        tf_s, tb_s = self.densify(max_batch)
        cluster = self.cluster()
        if sort_by_memory:
            order = sorted(range(self.D),
                           key=lambda i: (-cluster.devices[i].mem_bytes,
                                          -cluster.devices[i].flops))
            cluster = Cluster(tuple(cluster.devices[i] for i in order),
                              cluster.bandwidth, cluster.bw_matrix)
            tf_s, tb_s = tf_s[order], tb_s[order]
        return Profile.measured(table, cluster, max_batch, tf_s, tb_s)

    def device_rows(self, table: LayerTable, max_batch: int,
                    dev: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """One device's densified ``(tf, tb)`` tables, ``(max_batch+1, L)``.

        The newcomer-admission view: a single-device on-arrival sweep
        (``launch.profile.measure_model`` on the joining board) becomes the
        row ``extend_profile`` appends.  Validates the measured layers
        against ``table`` like ``to_profile`` does — an incompatible sweep
        raises ``ProfileError`` so callers can fall back to the analytic
        device model."""
        if not 0 <= dev < self.D:
            raise ProfileError(f"device index {dev} out of range "
                               f"(artifact has {self.D} rows)")
        if table.L != self.L or tuple(l.name for l in table.layers) != \
                self.layer_names:
            raise ProfileError(
                f"layer table {table.name!r} ({table.L} layers) does not "
                f"match the measured layers {list(self.layer_names)}")
        tf_s, tb_s = self.densify(max_batch)
        return tf_s[dev], tb_s[dev]

    # -- staleness / compatibility ------------------------------------------

    def compatibility_issues(self, cfg, seq_len: int,
                             check_device: bool = True,
                             device=None) -> list[str]:
        """Human-readable reasons this artifact should NOT be used.

        Empty list == compatible.  Checks the model-config + seq_len
        fingerprint and (optionally) the fingerprint of ``device`` (default:
        the card when there is one); callers
        are expected to fall back to ``Profile.analytic`` with a warning
        when issues are reported.
        """
        issues = []
        if self.version > PROFILE_VERSION:
            issues.append(f"artifact version {self.version} is newer than "
                          f"supported {PROFILE_VERSION}")
        want = config_fingerprint(cfg, seq_len)
        if want != self.config_hash:
            issues.append(
                f"model/seq fingerprint mismatch: artifact profiled "
                f"{self.arch!r} at seq_len={self.seq_len} "
                f"(hash {self.config_hash}), current is {cfg.name!r} at "
                f"seq_len={seq_len} (hash {want})")
        if check_device:
            cur = device_fingerprint(device)
            if cur != self.device_hash:
                issues.append(
                    f"device fingerprint mismatch: artifact measured on "
                    f"{self.device_hash}, current host is {cur} — re-run "
                    f"repro_torch.launch.profile on this host")
        return issues


def save_profile(path: str, mp: MeasuredProfile) -> None:
    """Serialize a ``MeasuredProfile`` to versioned JSON.

    Floats go through Python ``repr`` (the json encoder), which round-trips
    IEEE-754 doubles exactly — ``load_profile(save_profile(mp))`` is
    bit-identical, pinned by tests.
    """
    doc = {
        "schema": PROFILE_SCHEMA,
        "version": mp.version,
        "arch": mp.arch,
        "seq_len": mp.seq_len,
        "batch_sizes": list(mp.batch_sizes),
        "layer_names": list(mp.layer_names),
        "device_names": list(mp.device_names),
        "config_hash": mp.config_hash,
        "device_hash": mp.device_hash,
        "mem_bytes": list(mp.mem_bytes),
        "est_flops": list(mp.est_flops),
        "bandwidth": mp.bandwidth,
        "repeats": mp.repeats,
        "meta": mp.meta,
        "tf": np.asarray(mp.tf, np.float64).tolist(),
        "tb": np.asarray(mp.tb, np.float64).tolist(),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def load_profile(path: str) -> MeasuredProfile:
    """Parse a ``save_profile`` artifact, validating schema and shapes."""
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ProfileError(f"{path}: not valid JSON ({e})") from e
    if doc.get("schema") != PROFILE_SCHEMA:
        raise ProfileError(
            f"{path}: schema {doc.get('schema')!r} != {PROFILE_SCHEMA!r}")
    missing = [k for k in ("version", "arch", "seq_len", "batch_sizes",
                           "layer_names", "device_names", "config_hash",
                           "device_hash", "mem_bytes", "est_flops", "tf",
                           "tb") if k not in doc]
    if missing:
        raise ProfileError(f"{path}: missing keys {missing}")
    return MeasuredProfile(
        arch=doc["arch"], seq_len=int(doc["seq_len"]),
        batch_sizes=tuple(int(b) for b in doc["batch_sizes"]),
        layer_names=tuple(doc["layer_names"]),
        tf=np.asarray(doc["tf"], np.float64),
        tb=np.asarray(doc["tb"], np.float64),
        device_names=tuple(doc["device_names"]),
        config_hash=doc["config_hash"], device_hash=doc["device_hash"],
        mem_bytes=tuple(float(m) for m in doc["mem_bytes"]),
        est_flops=tuple(float(x) for x in doc["est_flops"]),
        bandwidth=float(doc.get("bandwidth", MBPS_1000)),
        repeats=int(doc.get("repeats", 1)), meta=doc.get("meta", {}),
        version=int(doc["version"]))
