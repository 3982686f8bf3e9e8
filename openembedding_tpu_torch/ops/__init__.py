"""Device ops of the port: the kernels (`gather`, `gather_windows`, `apply`,
`hash_probe`), their build (`_build`) and the table ops built on them
(`dedup`, `sparse`).

Callers reach every kernel through its module attribute
(`gather.gather_rows`, `gather_windows.gather_rows_windows`,
`apply.fused_sparse_apply`, `hash_probe.find_or_insert`), so
`plain_versions()` can put the plain PyTorch versions in their place for a
reference run.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict


def _kernel_modules():
    from . import apply, gather, gather_windows, hash_probe
    return (gather, gather_windows, apply, hash_probe)


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches counted by its wrapper}, every kernel."""
    out: Dict[str, int] = {}
    for m in _kernel_modules():
        out.update(m.LAUNCHES)
    return out


def reset_launch_counts() -> None:
    for m in _kernel_modules():
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


@contextmanager
def plain_versions():
    """Every kernel wrapper replaced by its plain PyTorch version for the
    duration (a reference run on the card; nothing launches a kernel)."""
    from ..tables.hash_table import hash_find_or_insert_reference
    gather, gather_windows, apply, hash_probe = _kernel_modules()
    swaps = [(gather, "gather_rows", gather.gather_rows_reference),
             (gather_windows, "gather_rows_windows",
              gather_windows.gather_rows_windows_reference),
             (apply, "fused_sparse_apply", apply.fused_sparse_apply_reference),
             (hash_probe, "find_or_insert", hash_find_or_insert_reference)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, plain in swaps:
        setattr(m, name, plain)
    try:
        yield
    finally:
        for m, name, kernel in saved:
            setattr(m, name, kernel)
