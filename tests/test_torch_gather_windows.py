"""The port's window-batched gather against the JAX package's.

`ops/gather_windows.gather_rows_windows` on CPU tensors (so its plain
version, the same prepass with the windows staged by tensor indexing)
against the JAX `pallas_sparse.gather_rows_windows(..., interpret=True)`,
run as `tests/test_pallas.py` runs it, on the same numpy inputs. The cases
are that file's contract cases (clustered sorted ids, unsorted uniform ids,
table-edge windows, out-of-range ids at both ends, a table smaller than the
window, 700 sorted ids over several blocks with window 32), each with a
float32 and a bfloat16 table and with int32 and int64 ids.

Tolerance: none. The gather is a copy, so every case is bit-exact, and
each also equals the per-row `gather.gather_rows_reference`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openembedding_tpu.ops import pallas_sparse
from openembedding_tpu_torch.ops import gather, gather_windows


def _table(rng, n_rows, dim):
    return rng.standard_normal((n_rows, dim)).astype(np.float32)


def _case(name):
    """-> (n_rows, dim, ids, window, block) of one contract case."""
    rng = np.random.default_rng({"clustered": 3, "uniform": 3, "edges": 3,
                                 "oob": 3, "small": 4, "multiblock": 5}[name])
    if name == "small":
        return 8, 4, np.asarray([0, 3, 7, 9, -1]), 16, 256
    if name == "multiblock":
        return 4096, 8, np.sort(rng.integers(0, 4096, size=700)), 32, 256
    ids = {"clustered": np.concatenate([
               np.sort(rng.integers(0, 64, size=40)),
               np.sort(rng.integers(64, 1000, size=24))]),
           "uniform": rng.integers(0, 1000, size=77),
           "edges": np.asarray([0, 1, 2, 998, 999]),
           "oob": np.asarray([-3, 5, 1005])}[name]
    return 1000, 12, ids, 16, 256


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16
                  ).numpy()


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["clustered", "uniform", "edges", "oob",
                                  "small", "multiblock"])
def test_window_gather_matches_jax_interpret(case, table_dtype):
    n_rows, dim, ids, window, block = _case(case)
    w_np = _table(np.random.default_rng(n_rows), n_rows, dim)
    w_jax = jnp.asarray(w_np, getattr(jnp, table_dtype))
    want = pallas_sparse.gather_rows_windows(
        w_jax, jnp.asarray(ids, jnp.int32), window=window, block=block,
        interpret=True)
    want_bits = np.asarray(want).view(
        np.int32 if table_dtype == "float32" else np.int16)
    w = torch.from_numpy(w_np).to(getattr(torch, table_dtype))
    for id_dtype in (torch.int32, torch.int64):
        rows = torch.from_numpy(ids).to(id_dtype)
        got = gather_windows.gather_rows_windows(w, rows, window=window,
                                                 block=block)
        assert got.dtype == w.dtype and got.shape == (len(ids), dim)
        np.testing.assert_array_equal(_bits(got), want_bits,
                                      err_msg=str(id_dtype))
        np.testing.assert_array_equal(
            _bits(got), _bits(gather.gather_rows_reference(w, rows)))


def test_prepass_counts_each_blocks_distinct_windows():
    """`window_prepass` against numpy: per block, the number of distinct
    windows of the clamped ids (padding repeats the last id), every row's
    staged position holds its own row, -1 marks out-of-range ids; the
    staging reads those windows once."""
    rng = np.random.default_rng(6)
    n_rows, window, block = 5000, 16, 64
    ids = np.concatenate([np.sort(rng.integers(0, 300, 150)),
                          rng.integers(-10, n_rows + 10, 100)])
    plan = gather_windows.window_prepass(n_rows, torch.from_numpy(ids),
                                         block=block, window=window)
    clamped = np.clip(ids, 0, n_rows - 1)
    nb = -(-len(ids) // block)
    padded = np.concatenate([clamped, np.full(nb * block - len(ids),
                                              clamped[-1])])
    per = padded.reshape(nb, block)
    want_nw = [len(np.unique(b // window)) for b in per]
    assert plan.nw.tolist() == want_nw
    bases = plan.bases.numpy().reshape(nb, block)
    so = plan.slotoff.numpy().reshape(-1)
    for i, r in enumerate(ids):
        if not 0 <= r < n_rows:
            assert so[i] == -1
            continue
        b = i // block
        slot, off = divmod(int(so[i]), window)
        assert slot < want_nw[b]
        assert bases[b, slot] + window <= n_rows
        assert bases[b, slot] + off == r
    # staging the runs at least half dense, the kernel reads their spans
    # only, never more than the whole windows the TPU kernel's plan read
    staged = gather_windows.staged_bytes(ids, n_rows, 40, block=block,
                                         window=window, stage_share=0.5)
    assert staged == _numpy_staged(ids, n_rows, 40, block, window, 0.5)
    assert 0 < staged.bytes <= sum(want_nw) * window * 40


def _numpy_staged(ids, n_rows, row_bytes, block, window, share,
                  base_offset=0):
    """The kernel's staging rule, run by run: -> (runs, rows, bytes)."""
    n = len(ids)
    tile = min(block, max(8, n), gather_windows.TILE)
    budget = gather_windows.STAGE_BYTES
    runs = rows = nbytes = 0
    for t0 in range(0, n, tile):
        end, used, i = min(t0 + tile, n), 0, t0
        while i < end:
            if not 0 <= ids[i] < n_rows:
                i += 1
                continue
            j = i
            while (j + 1 < end and 0 <= ids[j + 1] < n_rows
                   and ids[j + 1] // window == ids[i] // window):
                j += 1
            run = ids[i:j + 1]
            lo, hi, count = int(run.min()), int(run.max()), j + 1 - i
            i = j + 1
            if count < gather_windows.STAGE_MIN_ROWS or count < share * (
                    hi - lo + 1):
                continue
            a = (base_offset + lo * row_bytes) // 16 * 16
            z = -(-(base_offset + (hi + 1) * row_bytes) // 16) * 16
            if a < base_offset or z > base_offset + n_rows * row_bytes or (
                    z - a > budget):
                continue
            if used + z - a <= budget:
                runs, rows, nbytes = runs + 1, rows + count, nbytes + z - a
            used += z - a
    return runs, rows, nbytes


def _staging_case(name):
    """-> (ids, n_rows, row_bytes, window, block, base_offset)."""
    rng = np.random.default_rng(11)
    if name == "sorted":
        return np.sort(rng.integers(0, 3000, 2000)), 5000, 40, 16, 256, 0
    if name == "unsorted":
        return rng.integers(0, 400, 2000), 5000, 40, 16, 256, 0
    if name == "duplicates":
        ids = np.repeat(np.sort(rng.integers(0, 2000, 700)), 3)
        return ids, 5000, 40, 64, 256, 0
    if name == "out_of_range":
        ids = np.sort(rng.integers(-50, 1100, 1500))
        ids[::7] = -1
        return ids, 1000, 40, 16, 128, 0
    if name == "last_partial_window":  # 1000 rows = 62 windows of 16 + 8
        ids = np.sort(rng.integers(900, 1003, 400))
        return ids, 1000, 36, 16, 64, 8
    # rows of 2 KB: dense runs of 16 rows fill the staging buffer
    return np.sort(rng.integers(0, 600, 1000)), 600, 2048, 16, 256, 0


@pytest.mark.parametrize("share", [0.0, 0.5, float("inf")])
@pytest.mark.parametrize("case", ["sorted", "unsorted", "duplicates",
                                  "out_of_range", "last_partial_window",
                                  "buffer_full"])
def test_staged_bytes_matches_a_run_by_run_count(case, share):
    """`staged_bytes`, the kernel's run and staging rule on the host,
    against the rule applied run by run in plain Python: sorted and
    unsorted ids, duplicates, out-of-range ids, the table's last partial
    window (with rows of 36 bytes on a table 8 bytes past a 16-byte
    boundary, where widened spans cross the table's end), and runs that
    overflow the staging buffer."""
    ids, n_rows, row_bytes, window, block, base = _staging_case(case)
    got = gather_windows.staged_bytes(
        torch.from_numpy(ids), n_rows, row_bytes, block=block, window=window,
        stage_share=share, base_offset=base)
    want = _numpy_staged(ids, n_rows, row_bytes, block, window, share, base)
    assert tuple(got) == want
    if share == float("inf"):
        assert want == (0, 0, 0)
    elif case in ("sorted", "duplicates", "buffer_full"):
        assert want[0] > 0  # dense runs stage
    if case == "buffer_full" and share == 0.0:
        assert want[2] <= gather_windows.STAGE_BYTES * -(-len(ids) // block)
        assert want[1] < len(ids)  # some dense runs did not fit


def test_wrapper_edges_on_cpu():
    """Empty ids, ids of any shape (flattened, as the JAX function does),
    int64 ids past 2^31 (zero rows), and the refusals."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(_table(rng, 300, 5))
    empty = gather_windows.gather_rows_windows(
        w, torch.zeros(0, dtype=torch.int64))
    assert empty.shape == (0, 5)
    ids = rng.integers(-2, 302, (6, 7))
    ids[0, :3] = [1 << 40, -(1 << 40), (1 << 31) + 1]
    rows = torch.from_numpy(ids)
    got = gather_windows.gather_rows_windows(w, rows, window=32, block=8)
    assert got.shape == (42, 5)
    assert torch.equal(got, gather.gather_rows_reference(w, rows.reshape(-1)))
    assert not got[:3].any()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gather_windows.gather_rows_windows(w.double(), rows)
    with pytest.raises(TypeError, match="int32 or int64"):
        gather_windows.gather_rows_windows(w, rows.to(torch.int16))
    with pytest.raises(ValueError, match="positive"):
        gather_windows.gather_rows_windows(w, rows, window=0)
