"""PyTorch/CUDA port of the ``repro`` package (serving slice).

The package mirrors ``repro``'s layout and names: ``repro_torch/models/
attention.py`` is the counterpart of ``repro/models/attention.py`` and so
on.  It imports ``torch`` and never ``jax`` or anything of ``repro``; the
parameter layout (weights ``(in, out)``, periods stacked on a leading axis,
decode caches ``(n_periods, B, S, Hkv, D)``) is ``repro``'s, so weights
carry across by name through :mod:`repro_torch.interop`.

The three compute kernels on the serving path (decode attention, flash
attention, fused SwiGLU) are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``; their plain PyTorch versions in ``kernels/ref.py`` run on CPU
tensors.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
