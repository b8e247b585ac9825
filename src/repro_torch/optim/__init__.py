"""Optimizers over trees of tensors: AdamW, SGD-momentum, schedules.

The port of ``repro.optim``.  ``repro``'s updates are pure; here the
parameters, the moments and (for clipping) the gradients are updated **in
place**, because at full width a second copy of the parameters and moments
does not fit on the card (fp32 phi3-mini: 15.3 GB each).  ``update`` still
returns ``(params, state)`` so the call sites read as ``repro``'s.  The
arithmetic is ``repro``'s, op for op, with the bias corrections and the
learning rate computed as float32 tensors from the step counter (as
``step.astype(jnp.float32)`` does).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the parameters' device
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float | None = 1.0
    moment_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        dt = getattr(torch, self.moment_dtype)
        device = tree_leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          tree_map(zeros, params), tree_map(zeros, params))

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step.  ``params``, ``state.m``/``state.v`` and (when clipping)
        ``grads`` are updated in place; returns ``(params, new_state)``."""
        step = state.step + 1
        if self.grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            for g in tree_leaves(grads):
                g.mul_(scale)
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        lr = self._lr(step)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            g = g.to(m.dtype)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            del g
            u = m / bc1
            den = (v / bc2).sqrt_().add_(self.eps)
            u.div_(den)
            del den
            if self.weight_decay:
                u.add_(self.weight_decay * p.float())
            p.sub_(u.mul_(lr))
            del u            # before the next leaf's temporaries are made
        return params, AdamWState(step, state.m, state.v)


class SGDState(NamedTuple):
    step: torch.Tensor
    mom: dict


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float | Callable = 1e-2
    momentum: float = 0.9
    grad_clip: float | None = None

    def init(self, params) -> SGDState:
        device = tree_leaves(params)[0].device
        return SGDState(torch.zeros((), dtype=torch.int32, device=device),
                        tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params))

    @torch.no_grad()
    def update(self, grads, state: SGDState, params):
        step = state.step + 1
        if self.grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            for g in tree_leaves(grads):
                g.mul_(scale)
        lr = self.lr(step) if callable(self.lr) else self.lr
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state.mom)):
            m.mul_(self.momentum).add_(g.float())
            p.sub_(m * lr)
        return params, SGDState(step, state.mom)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def f(step):
        s = step.to(torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup, warm, cos)
    return f
