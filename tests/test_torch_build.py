"""The kernel build's cache key (``kernels/_build.py``), on the CPU.

Each ``csrc/<name>.cu`` is compiled into ``_build/<name>-<hash>.so`` and a
library already there is loaded as it is, so the hash must change whenever
anything the compiler reads changes: the source itself and the headers it
includes from ``csrc/`` (``tc_tf32.cuh``, shared by the flash-attention
forward and backward).  These tests edit a copy of ``csrc/`` and watch the
paths.
"""

import re
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return copy


def _paths():
    return {name: _build._lib_path(name) for name in _build.SOURCES}


def test_paths_are_stable_and_distinct(csrc):
    first = _paths()
    assert first == _paths()
    assert len(set(first.values())) == len(first)
    assert all(p.parent == csrc.parent / "_build" and p.name.startswith(f"{n}-")
               for n, p in first.items())


@pytest.mark.parametrize("header", ["tc_tf32.cuh", "new_helpers.cuh"])
def test_a_header_edit_moves_every_path(csrc, header):
    """Editing (or adding) a header rebuilds every library: a source that
    includes it would otherwise load a stale build."""
    before = _paths()
    path = csrc / header
    path.write_bytes((path.read_bytes() if path.exists() else b"") + b"\n// edited\n")
    after = _paths()
    assert all(after[n] != before[n] for n in before)


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd", "mamba_scan"])
def test_a_source_edit_moves_only_its_path(csrc, name):
    before = _paths()
    src = csrc / f"{name}.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    after = _paths()
    assert {n for n in before if after[n] != before[n]} == {name}


def test_quoted_includes_are_headers_beside_the_sources():
    """Every ``#include "..."`` in ``csrc/`` names a ``.cuh`` there (nvcc
    finds it beside the source, and the hash covers it); the flash forward
    and backward share ``tc_tf32.cuh``."""
    includes = {}
    for src in sorted(_build.CSRC.glob("*.cu*")):
        for inc in re.findall(r'^#include "([^"]+)"', src.read_text(), flags=re.M):
            assert inc.endswith(".cuh") and (_build.CSRC / inc).is_file(), (src.name, inc)
            includes.setdefault(inc, set()).add(src.name)
    assert {"flash_attention.cu", "flash_attention_bwd.cu"} <= includes["tc_tf32.cuh"]
