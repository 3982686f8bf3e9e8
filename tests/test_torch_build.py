"""The port's kernel build key (`openembedding_tpu_torch/ops/_build.py`).

A library's file name carries `_build.digest(name)`, so an edited source is
rebuilt rather than a stale library loaded. The sources include the shared
row-copy core `csrc/gather_core.cuh`; the key must change when that header
changes, or a kernel built against the old header would be loaded. Checked
on a temporary copy of `csrc/`; nothing is compiled.
"""

import os
import shutil

import pytest

from openembedding_tpu_torch.ops import _build

KERNELS = ("gather_rows", "gather_rows_windows", "fused_sparse_apply")


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, dst)
    return str(dst)


def _append(path, text):
    with open(path, "a") as f:
        f.write(text)


def test_digest_is_stable_and_differs_between_kernels(csrc):
    keys = {k: _build.digest(k, csrc) for k in KERNELS}
    assert keys == {k: _build.digest(k) for k in KERNELS}
    assert len(set(keys.values())) == len(KERNELS)


@pytest.mark.parametrize("edited", ["gather_core.cuh", "gather_rows.cu",
                                    "new_header.cuh"])
def test_digest_changes_when_a_source_or_header_changes(csrc, edited):
    before = {k: _build.digest(k, csrc) for k in KERNELS}
    _append(os.path.join(csrc, edited), "\n// edited\n")
    after = {k: _build.digest(k, csrc) for k in KERNELS}
    if edited == "gather_rows.cu":
        changed = {"gather_rows"}
    else:  # any header may be included by any source
        changed = set(KERNELS)
    assert {k for k in KERNELS if after[k] != before[k]} == changed
