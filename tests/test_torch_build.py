"""The kernel build's cache key (``repro_torch.kernels._build.library_path``).

A library is rebuilt when its key changes, so the key must cover every
byte that goes into it: the source, the shared headers ``csrc/*.cuh`` it
may include, and the flags.  Checked on a copy of ``csrc`` (nothing is
compiled: this machine has no nvcc).
"""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture()
def csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    return copy


def test_the_copy_keys_as_the_package_does(csrc):
    for name in _build.SOURCES:
        assert _build.library_path(name, csrc) == _build.library_path(name)


@pytest.mark.parametrize("edit", ["header bytes", "new header",
                                  "header renamed", "source bytes"])
def test_key_moves_with_every_input(csrc, edit):
    before = {name: _build.library_path(name, csrc)
              for name in _build.SOURCES}
    header = csrc / "sm90.cuh"
    if edit == "header bytes":
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
    elif edit == "new header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    elif edit == "header renamed":
        header.rename(csrc / "sm90_old.cuh")
    else:
        src = csrc / "segment_matmul.cu"
        src.write_bytes(src.read_bytes() + b"\n")
    after = {name: _build.library_path(name, csrc)
             for name in _build.SOURCES}
    moved = {name for name in _build.SOURCES if after[name] != before[name]}
    if edit == "source bytes":
        assert moved == {"segment_matmul"}
    else:
        assert moved == set(_build.SOURCES)
