"""Move ``repro``'s parameter, decode-state, optimizer-state and
error-feedback trees to torch and back.

A tree is nested dicts, tuples and lists of numpy arrays (what
``jax.device_get`` or ``np.asarray`` gives for ``repro``'s pytrees), with
periods stacked on the leading axis.  The torch tree keeps the same names,
nesting and layout, so the port's functions take it as it is.

bfloat16 arrays (numpy dtype ``bfloat16``, registered by ``ml_dtypes``)
cross bit for bit through int16: ``view(np.uint16)`` -> ``torch.int16`` ->
``view(torch.bfloat16)``.  This module imports neither ``ml_dtypes`` nor
``jax``; turning bf16 tensors back into numpy needs the dtype to be
registered by whoever made the tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim import AdamWState


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def array_to_tensor(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a.view(np.uint16).view(np.int16), copy=True)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as e:
            raise TypeError("numpy has no bfloat16 dtype registered (import "
                            "ml_dtypes first) to hold a bfloat16 tensor") from e
        return t.view(torch.int16).numpy().view(np.uint16).view(bf16)
    return t.numpy()


def params_from_numpy(tree, device="cuda"):
    """``repro`` parameter tree (numpy leaves) -> the port's (torch leaves on
    ``device``: the card unless the caller passes ``"cpu"``)."""
    return _map(lambda a: array_to_tensor(a, device), tree)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`."""
    return _map(tensor_to_array, tree)


#: ``repro`` decode-state tree (stacked KV caches) -> torch tensors
states_from_numpy = params_from_numpy

#: ``repro``'s error-feedback tree ``{"bucket<i>": (1, L_i) f32}`` at one
#: device -> the port's, which has the same keys and shapes
ef_from_numpy = params_from_numpy
ef_to_numpy = params_to_numpy


def opt_state_from_numpy(state, device="cuda"):
    """``repro``'s ``AdamWState(step, m, v)`` (numpy leaves) -> the port's."""
    step, m, v = state
    return AdamWState(array_to_tensor(np.asarray(step, np.int32), device),
                      params_from_numpy(m, device), params_from_numpy(v, device))


def opt_state_to_numpy(state):
    """The port's ``AdamWState`` -> a ``(step, m, v)`` tuple of numpy trees,
    in the field order of ``repro``'s ``AdamWState``."""
    return (tensor_to_array(state.step), params_to_numpy(state.m),
            params_to_numpy(state.v))
