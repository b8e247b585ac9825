"""Logical parallelism layout (``repro.distributed.mesh``'s arithmetic).

``repro`` refines a production ``(data, model)`` mesh into
``(pod, data, stage, tp)``: pipeline stages times tensor parallelism on the
``model`` axis, data parallelism over ``(pod, data)``.  The port has no
device mesh yet.  On one card the plan is ``MeshPlan(1, 1, P, 1)``: the
``model`` axis is P *virtual* stages run in turn on the card, and nothing
is tensor-parallel.  ``refine`` and ``pick_stage_count`` are ``repro``'s
arithmetic on axis sizes alone.
"""

from __future__ import annotations

import dataclasses

AXES = ("pod", "data", "stage", "tp")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    pod: int = 1
    data: int = 1
    stage: int = 1
    tp: int = 1

    @property
    def dp_shards(self) -> int:
        return self.pod * self.data

    @property
    def model(self) -> int:
        return self.stage * self.tp


SINGLE = MeshPlan()


def refine(model: int, stage: int) -> tuple[int, int]:
    """Split a ``model`` axis of size ``model`` into ``(stage, tp)``
    (``repro``'s ``refine_mesh`` on sizes)."""
    if stage < 1 or model % stage:
        raise ValueError(f"stage count {stage} does not divide the model axis {model}")
    return stage, model // stage


def mesh_plan(stage: int, model: int | None = None) -> MeshPlan:
    """The plan for ``stage`` stages on a ``model`` axis (default: one card
    running ``stage`` virtual stages, so ``model = stage`` and tp = 1)."""
    stage, tp = refine(stage if model is None else model, stage)
    return MeshPlan(stage=stage, tp=tp)


def pick_stage_count(n_layers: int, pattern_len: int, model_axis: int,
                     n_heads: int, max_stage: int | None = None) -> int:
    """Choose the pipeline-stage count for an architecture.

    Constraints: stage divides the model axis; tp = model/stage must divide
    n_heads (query heads are tp-sharded); prefer the largest stage count
    whose period padding waste is <= 12.5%.
    """
    n_periods = n_layers // pattern_len
    best = 1
    divisors = [d for d in (16, 8, 4, 2, 1) if model_axis % d == 0]
    for s in divisors:
        if max_stage and s > max_stage:
            continue
        tp = model_axis // s
        if n_heads % tp != 0 and tp % max(n_heads, 1) != 0:
            continue
        padded = -(-n_periods // s) * s
        waste = (padded - n_periods) / padded
        if waste <= 0.125:
            best = s
            break
    return best
