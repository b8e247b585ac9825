"""The train step on one card (the counterpart of ``repro.runtime.train``).

``build_train_step`` wires the pieces: the parameters (the period stack
unpadded, in model order, each stage owning a range of it: the uniform
split, or a planner split from ``build_train_step_from_lowered``), the
virtual-stage pipeline loss
(:func:`repro_torch.runtime.pipeline.spmd_loss_fn`), its gradient by
autograd, the bucketed / compressed gradient path, and the optimizer
update.  ``repro`` builds the same over a device mesh with ``shard_map``;
here there is one card, so there are no shardings and no collectives.

Gradients are accumulated into one buffer per stacked leaf: each period's
parameters enter the graph as views of the stacked tensors (detached, so
autograd does not build a full-size zero tensor per period and view) whose
``.grad`` is preset to the matching view of the stacked gradient buffer, so
autograd adds into the buffer in place; the pipeline gives each
micro-batch its own such leaves (``pipeline._leaf_per_use``).

**Gradient buckets.**  The card is one member of the data-parallel group.
:func:`grad_buckets` groups the leaves by the mesh axes their gradient
would be summed over in ``repro`` (a leaf's "free" axes under its
PartitionSpec) and packs each group into buckets of at most ``bucket_mb``
MiB of float32, in tree-flatten order; a leaf larger than the cap is a
bucket of its own, and its flat view needs no copy.  With ``compress`` each
bucket is flattened, round-tripped through the wire (``roundtrip_ef`` with
error feedback, else ``roundtrip``) and written back.  Unlike ``repro``'s
``_bucketed_grad_fn`` there is **no** ``1/n_dev`` scaling: the gradient here
is already the true one (``repro``'s division undoes a psum transpose and is
faulty at more than one device under jax 0.9; at one device it is 1).

The step functions keep ``repro``'s arities:

* ``grad_fn(params, batch) -> ((loss, metrics), grads)``;
  ``step_fn(params, opt_state, batch) -> (params, opt_state, loss, metrics)``;
* bucketed: ``grad_fn(params, batch, ef) -> ((loss, metrics), grads, ef)``;
  ``step_fn(params, opt_state, ef, batch) -> (params, opt_state, ef, loss,
  metrics)``, with ``init_ef()`` the zero residual tree (``{}`` when error
  feedback is off);
* ``loss_fn(params, batch) -> (loss, metrics)`` without a gradient;
* staleness 1 (``spec.staleness``): ``async_step_fn(params, opt_state,
  held, batch) -> (params, opt_state, held, loss, metrics)`` (bucketed:
  ``(params, opt_state, held, ef, batch) -> (params, opt_state, held, ef,
  loss, metrics)``) and ``flush_fn(params, opt_state, held) -> (params,
  opt_state)``.

**Staleness 1.**  ``repro``'s bounded-stale step keeps round r-1's
gradients (``grad_buf``) and applies them with ``optimizer.update`` after
taking round r's at the old parameters.  Here that buffer would be another
copy of every gradient (15.3 GB at fp32 phi3-mini, beside a 67.6 GB step
peak), so the update is split (``optim``): round r takes its gradients at
p_r, applies the parameter half of round r-1's update (a ``HeldUpdate``),
then takes round r's gradients into the moments and the step counter and
holds the parameter half.  The arithmetic and its order are ``repro``'s
``update(grad_buf, ...)`` exactly; what differs is the state held between
rounds: the moments and the step already include round r-1.  The first
round has nothing held (``held=None``): it takes gradients only, as
``repro``'s first round calls ``grad_fn`` alone, so the update count and
the schedule equal the synchronous run's.  ``flush_fn`` applies what is
held: the end of training, and every swap of the step (a staleness
barrier).

Parameters and optimizer state are updated in place (see ``repro_torch.optim``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.mesh import MeshPlan, mesh_plan, pick_stage_count
from repro_torch.kernels.quant_transfer import roundtrip, roundtrip_ef
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_model
from repro_torch.optim import AdamW, tree_leaves, tree_map

from .pipeline import TrainSpec, spmd_loss_fn

MESH_AXES = ("pod", "data", "stage", "tp")


def default_n_micro(cfg: ModelConfig, plan: MeshPlan, global_batch: int) -> int:
    """Micro-batch count: enough to fill the pipeline (>= 2*stages when the
    local batch allows), dividing the per-shard batch."""
    b_loc = global_batch // plan.dp_shards
    target = min(2 * plan.stage, b_loc)
    m = 1
    for cand in range(target, 0, -1):
        if b_loc % cand == 0:
            m = cand
            break
    return max(m, 1)


@dataclasses.dataclass
class TrainStep:
    spec: TrainSpec
    device: torch.device
    step_fn: object
    loss_fn: object
    grad_fn: object
    init_ef: object = None
    # [(free_axes, leaf_indices, sizes), ...] in tree_leaves order (bucketed only)
    buckets: tuple = ()
    # staleness 1 only (module docstring)
    async_step_fn: object = None
    flush_fn: object = None

    def shard_batch(self, batch_np: dict) -> dict:
        """Put a host (numpy) batch on the card."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch_np.items()}


def _check_staleness(staleness: int) -> int:
    if staleness not in (0, 1):
        raise ValueError(f"staleness must be 0 (sync) or 1 (bounded-stale "
                         f"async), got {staleness}")
    return staleness


def _default_double_buffer(double_buffer: bool | None, staleness: int) -> bool:
    """The async runtime double-buffers by default; the sync runtime keeps
    the serialized sends unless asked."""
    return staleness >= 1 if double_buffer is None else bool(double_buffer)


def _check_compress(compress: str | None) -> str:
    compress = "none" if compress is None else str(compress)
    if compress not in ("none", "int8", "fp8"):
        raise ValueError(f"compress must be 'none', 'int8' or 'fp8', got {compress!r}")
    return compress


# ---------------------------------------------------------------------------
# Gradient buckets
# ---------------------------------------------------------------------------


def tree_paths(tree, prefix=()) -> list:
    """Key paths of the leaves, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, prefix + (i,))]
    return [prefix]


def _leaf_axes(path) -> set:
    """Mesh axes in a leaf's PartitionSpec under ``repro``'s training layout
    (``distributed/sharding.py``), for the attn + dense-MLP leaves."""
    names = [k for k in path if isinstance(k, str)]
    name, parent = names[-1], (names[-2] if len(names) > 1 else "")
    if name in ("embed", "head"):
        return {"tp"}                                # vocab-parallel
    used = {"stage"} if "periods" in names else set()
    if name in ("wq", "wk", "wv", "wo") or (parent == "mlp" and
                                            name in ("gate", "up", "down")):
        used.add("tp")                               # column / row parallel
    return used                                      # norms: replicated


def _free_axes(path) -> tuple:
    used = _leaf_axes(path)
    return tuple(ax for ax in MESH_AXES if ax not in used)


def grad_buckets(params, bucket_mb: float | None):
    """Static bucket partition of the gradient tree.

    Leaves are grouped by free-axes set and greedily packed into
    ``bucket_mb``-bounded buckets in tree-flatten order, as ``repro``'s
    ``grad_buckets`` does (with the whole leaf on the card as its size).
    Returns ``[(free_axes, leaf_indices, sizes), ...]``.
    """
    cap = float("inf") if bucket_mb is None else float(bucket_mb) * (1 << 20)
    groups: dict = {}
    for i, (path, leaf) in enumerate(zip(tree_paths(params), tree_leaves(params))):
        groups.setdefault(_free_axes(path), []).append((i, leaf.numel()))
    buckets = []
    for free, entries in sorted(groups.items()):
        cur: list = []
        cur_bytes = 0.0
        for i, n in entries:
            if cur and cur_bytes + n * 4 > cap:
                buckets.append((free, tuple(j for j, _ in cur), tuple(m for _, m in cur)))
                cur, cur_bytes = [], 0.0
            cur.append((i, n))
            cur_bytes += n * 4
        if cur:
            buckets.append((free, tuple(j for j, _ in cur), tuple(m for _, m in cur)))
    return buckets


def _ef_key(bi: int) -> str:
    return f"bucket{bi}"


def ef_zeros(buckets, device="cuda"):
    """The zero error-feedback state: one (1, L_b) float32 residual per
    bucket (``repro``'s (n_devices, L_b) at one device)."""
    return {_ef_key(bi): torch.zeros((1, sum(sizes)), dtype=torch.float32, device=device)
            for bi, (_, _, sizes) in enumerate(buckets)}


def wire_buckets(spec: TrainSpec, grads, ef, buckets):
    """Round-trip every bucket of ``grads`` through the wire, in place.
    Returns the new error-feedback tree."""
    fmt, tile = spec.compress, spec.quant_tile
    leaves = tree_leaves(grads)
    new_ef = dict(ef)
    for bi, (_, idxs, _) in enumerate(buckets):
        if len(idxs) == 1:
            flat = leaves[idxs[0]].view(-1)          # a leaf of its own: no copy
        else:
            flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
        if spec.error_feedback:
            k = _ef_key(bi)
            flat_hat, res = roundtrip_ef(flat, ef[k][0], fmt=fmt, tile=tile)
            new_ef[k] = res[None]
        else:
            flat_hat = roundtrip(flat, fmt=fmt, tile=tile)
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            leaves[i].view(-1).copy_(flat_hat[off:off + n])
            off += n
        del flat, flat_hat
    return new_ef


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------


def _bind_grads(params, grads):
    """A copy of the ``params`` tree whose leaves are detached views that
    require grad, each with ``.grad`` preset to the same view of ``grads``
    (so backward accumulates into ``grads`` in place).  The stacked
    ``periods`` become a list of per-period trees."""
    def leaf(p, g):
        t = p.detach().requires_grad_(True)
        t.grad = g
        return t

    bound = {k: tree_map(leaf, v, grads[k]) for k, v in params.items() if k != "periods"}
    stacked, gstacked = params["periods"], grads["periods"]
    n = tree_leaves(stacked)[0].shape[0]
    bound["periods"] = [tree_map(lambda p, g, i=i: leaf(p[i], g[i]), stacked, gstacked)
                        for i in range(n)]
    return bound


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``, with
    ``grads`` laid out as ``params`` (stacked periods)."""
    grads = tree_map(torch.zeros_like, params)
    with torch.enable_grad():
        loss, metrics = loss_fn(_bind_grads(params, grads), batch)
        loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------


def build_train_step(cfg: ModelConfig, global_batch: int, *, stage: int | None = None,
                     n_micro: int | None = None, optimizer: AdamW | None = None,
                     remat: bool = True, ce_chunk: int = 1024,
                     compress: str = "none", quant_tile: int = 256,
                     bucket_mb: float | None = None, error_feedback: bool = True,
                     staleness: int = 0, double_buffer: bool | None = None,
                     device="cuda") -> TrainStep:
    """The one-card train step for ``stage`` virtual stages (default: the
    stage count ``repro`` would pick on one device, i.e. 1), each owning its
    range of the uniform split ``pipeline.stage_ranges``."""
    device = _check_device(device)
    if stage is None:
        n_heads = cfg.attn.n_heads
        stage = pick_stage_count(cfg.n_layers, len(cfg.pattern), 1, n_heads)
    plan = mesh_plan(stage)
    if n_micro is None:
        n_micro = default_n_micro(cfg, plan, global_batch)
    if global_batch % n_micro:
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{n_micro} micro-batches")
    spec = TrainSpec(cfg=cfg, plan=plan, n_micro=n_micro, remat=remat,
                     ce_chunk=ce_chunk,
                     compress=_check_compress(compress), quant_tile=int(quant_tile),
                     bucket_mb=bucket_mb, error_feedback=bool(error_feedback),
                     staleness=_check_staleness(staleness),
                     double_buffer=_default_double_buffer(double_buffer, staleness))
    return _assemble_train_step(spec, optimizer, device)


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to train with the "
                           "plain versions on the CPU")
    return device


def _check_stage_periods(stage_periods, plan: MeshPlan, cfg: ModelConfig):
    stage_periods = tuple(tuple(r) for r in stage_periods)
    if len(stage_periods) != plan.stage:
        raise ValueError(f"stage_periods {stage_periods} has "
                         f"{len(stage_periods)} ranges for {plan.stage} stages")
    prev = 0
    for i, j in stage_periods:
        if i != prev or j <= i:
            raise ValueError(f"stage_periods {stage_periods} must be "
                             f"contiguous non-empty ranges from 0")
        prev = j
    if prev != cfg.n_periods:
        raise ValueError(f"stage_periods {stage_periods} covers "
                         f"[0, {prev}) but the model has "
                         f"{cfg.n_periods} periods")
    return stage_periods


def _check_shard_alloc(shard_alloc) -> None:
    if len(set(shard_alloc)) > 1:
        raise NotImplementedError(
            f"heterogeneous per-shard allocation {shard_alloc}: padded data "
            "shards need real data parallelism, a later slice of the port")


def train_spec_from_lowered(cfg: ModelConfig, model_axis: int, lowered, *,
                            remat: bool = True, ce_chunk: int = 1024,
                            compress: str = "none", quant_tile: int = 256,
                            bucket_mb: float | None = None,
                            error_feedback: bool = True, staleness: int = 0,
                            double_buffer: bool | None = None) -> TrainSpec:
    """Derive the static step configuration from a ``core.lowering``
    ``LoweredPlan`` (duck-typed: ``stage``/``n_micro``/``stage_periods``/
    ``global_batch``/``micro_alloc`` attributes) for a virtual model axis
    of ``model_axis`` devices on one card (data axis 1).

    tp = model_axis / stage is a label here: the math is unsharded.  So with
    a compressed wire and tp > 1 the gradient buckets pack whole leaves,
    where ``repro`` packs each tp shard's part; the quantization tiles fall
    differently, and the port is held to ``repro`` within the int8
    tolerance there, not bit for bit.  A plan's per-device allocation
    collapses onto the one data shard (``lower_micro_alloc``), so it is
    always uniform."""
    if model_axis % lowered.stage:
        raise ValueError(f"stage count {lowered.stage} does not divide the "
                         f"model axis {model_axis}")
    plan = mesh_plan(lowered.stage, model_axis)
    if getattr(lowered, "micro_alloc", None):
        from repro_torch.core.lowering import lower_micro_alloc
        _check_shard_alloc(lower_micro_alloc(lowered, plan.dp_shards))
    if lowered.global_batch % (plan.dp_shards * lowered.n_micro):
        raise ValueError(
            f"global batch {lowered.global_batch} not divisible into "
            f"{lowered.n_micro} micro-batches per {plan.dp_shards} data shards")
    stage_periods = _check_stage_periods(lowered.stage_periods, plan, cfg)
    return TrainSpec(cfg=cfg, plan=plan, n_micro=lowered.n_micro, remat=remat,
                     ce_chunk=ce_chunk, stage_periods=stage_periods,
                     compress=_check_compress(compress), quant_tile=int(quant_tile),
                     bucket_mb=bucket_mb, error_feedback=bool(error_feedback),
                     staleness=_check_staleness(staleness),
                     double_buffer=_default_double_buffer(double_buffer, staleness))


def build_train_step_from_lowered(cfg: ModelConfig, model_axis: int, lowered, *,
                                  optimizer: AdamW | None = None, device="cuda",
                                  **spec_kw) -> TrainStep:
    """The one-card train step for a ``LoweredPlan``: its stages run the
    periods of ``lowered.stage_periods`` from the unpadded stack."""
    device = _check_device(device)
    spec = train_spec_from_lowered(cfg, model_axis, lowered, **spec_kw)
    return _assemble_train_step(spec, optimizer, device)


def _assemble_train_step(spec: TrainSpec, optimizer: AdamW | None,
                         device: torch.device) -> TrainStep:
    optimizer = optimizer or AdamW(lr=1e-3)
    spmd = spmd_loss_fn(spec)

    @torch.no_grad()
    def loss_fn(params, batch):
        return spmd(params, batch)

    def take(grads, opt_state, params, held):
        """Staleness 1: the held parameter half, then this round's
        gradients into the optimizer state (module docstring)."""
        if held is not None:
            params = optimizer.apply_held(held, opt_state, params)
        opt_state, held = optimizer.take_grads(grads, opt_state)
        return params, opt_state, held

    def flush_fn(params, opt_state, held):
        return optimizer.apply_held(held, opt_state, params), opt_state

    stale = spec.staleness >= 1
    if not spec.bucketed:
        def grad_fn(params, batch):
            return value_and_grad(spmd, params, batch)

        def step_fn(params, opt_state, batch):
            (loss, metrics), grads = grad_fn(params, batch)
            params, opt_state = optimizer.update(grads, opt_state, params)
            return params, opt_state, loss, metrics

        def async_step_fn(params, opt_state, held, batch):
            (loss, metrics), grads = grad_fn(params, batch)
            params, opt_state, held = take(grads, opt_state, params, held)
            return params, opt_state, held, loss, metrics

        return TrainStep(spec=spec, device=device, step_fn=step_fn, loss_fn=loss_fn,
                         grad_fn=grad_fn, async_step_fn=async_step_fn if stale else None,
                         flush_fn=flush_fn if stale else None)

    # the bucket partition depends only on the tree's structure and shapes
    abstract = init_model(None, spec.cfg, "meta")
    buckets = tuple(grad_buckets(abstract, spec.bucket_mb))
    use_ef = spec.compress != "none" and spec.error_feedback

    def grad_fn(params, batch, ef):
        (loss, metrics), grads = value_and_grad(spmd, params, batch)
        if spec.compress != "none":
            ef = wire_buckets(spec, grads, ef, buckets)
        return (loss, metrics), grads, ef

    def step_fn(params, opt_state, ef, batch):
        (loss, metrics), grads, ef = grad_fn(params, batch, ef)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, ef, loss, metrics

    def async_step_fn(params, opt_state, held, ef, batch):
        (loss, metrics), grads, ef = grad_fn(params, batch, ef)
        params, opt_state, held = take(grads, opt_state, params, held)
        return params, opt_state, held, ef, loss, metrics

    def init_ef():
        return ef_zeros(buckets, device) if use_ef else {}

    return TrainStep(spec=spec, device=device, step_fn=step_fn, loss_fn=loss_fn,
                     grad_fn=grad_fn, init_ef=init_ef, buckets=buckets,
                     async_step_fn=async_step_fn if stale else None,
                     flush_fn=flush_fn if stale else None)


def init_train_state(seed: int, ts: TrainStep, optimizer: AdamW | None = None):
    """Parameters (random, from ``seed``) and optimizer state on ``ts.device``."""
    optimizer = optimizer or AdamW(lr=1e-3)
    gen = torch.Generator(device=ts.device).manual_seed(seed)
    params = init_model(gen, ts.spec.cfg, ts.device)
    return params, optimizer.init(params)
