"""Logical parallelism layout (``repro.distributed.mesh.MeshPlan``).

The serving slice runs on one card, so the only plan is ``(1, 1, 1, 1)``;
the pipeline and tensor-parallel slices will fill in the rest.
"""

from __future__ import annotations

import dataclasses


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
