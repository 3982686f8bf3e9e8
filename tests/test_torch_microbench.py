"""The port's kernel micro-benchmark (`openembedding_tpu_torch.microbench`)
at its CPU shapes (`--device cpu`: tables of 2^14 rows, n 2048, batch 256,
5 timed steps; the plain versions run).

- Every printed line is one JSON object naming its device and clock, and
  every section of the JAX tool (`tools/pallas_microbench.py`) is there at
  both widths: gather, window gather (two densities x windows 16 and 64),
  apply, and the train step through the graph, eager and plain.
- A planted mismatch raises and stops the run; the JAX tool printed
  `FAILED` and went on.
- The plain paths that the CPU run holds to themselves give the same bits
  whatever the thread count and the arrays' offsets.
"""

import json

import numpy as np
import pytest
import torch

from openembedding_tpu_torch import data, microbench, optimizers
from openembedding_tpu_torch.model import Trainer
from openembedding_tpu_torch.models import make_deepfm
from openembedding_tpu_torch.ops import apply, gather, gather_windows, sparse


def test_cpu_run_prints_one_json_line_per_measurement(capsys):
    records = microbench.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    parsed = [json.loads(ln) for ln in lines]
    assert parsed == records
    assert all(r["device"] == "cpu" and r["timer"] == "host_clock"
               for r in parsed)
    by = {}
    for r in parsed:
        by.setdefault(r["bench"], []).append(r)
    assert [r["table"] for r in by["gather"]] == ["f32 16384x64",
                                                  "f32 16384x128"]
    assert sorted((r["table"], r["ids"], r["window"])
                  for r in by["gather_windows"]) == sorted(
        (f"f32 16384x{d}", f"sorted {ids}", w) for d in (64, 128)
        for ids in ("uniform", "hot10%") for w in (16, 64))
    assert len(by["apply"]) == 2
    assert [r["mode"] for r in by["train_step"]] == ["graph", "eager",
                                                     "plain"]
    for r in by["gather"] + by["gather_windows"] + by["apply"]:
        assert r["bit_equal"] is True and r["ms"] > 0 and r["bound_ms"] > 0
    # what each staging rule stages: under inf nothing, and dense ids
    # form dense runs, so under the half-span rule more of the hot ids
    # stage than of the uniform ones
    for r in by["gather_windows"]:
        assert set(r["staged_by_share"]) == {"inf", "0.5", "0.0"}
        assert r["staged_by_share"]["inf"] == {"runs": 0, "rows": 0,
                                               "bytes": 0}
    for dim in (64, 128):
        for window in (16, 64):
            staged = {r["ids"]: r["staged_by_share"]["0.5"]["rows"]
                      for r in by["gather_windows"]
                      if r["table"] == f"f32 16384x{dim}"
                      and r["window"] == window}
            assert staged["sorted hot10%"] > staged["sorted uniform"]
    assert all(r["batch"] == 256 and r["steps"] == 5
               for r in by["train_step"])


def test_plain_paths_repeat_whatever_the_threads_and_offsets():
    """On the CPU the micro-benchmark holds the plain versions to
    themselves on clones, bit for bit. What could differ between two such
    runs does not change a bit: the intra-op thread count (ATen splits an
    op's elements between threads) and where the arrays start (vector
    loops peel a head and a tail). Held here for the apply at the
    micro-benchmark's CPU shapes and for three train steps."""
    rng = np.random.default_rng(0)
    gen = torch.Generator()
    gen.manual_seed(0)
    dim, vocab, n = 64, 1 << 14, 2048
    w0 = torch.randn((vocab, dim), generator=gen)
    ids = torch.from_numpy(rng.integers(0, vocab, n))
    opt = optimizers.Adagrad(learning_rate=0.05)
    accum0 = opt.init_slots(vocab, dim)["accum"]
    g, counts, idx = sparse._dedup_routed(
        vocab, ids, torch.randn((n, dim), generator=gen), None)

    def at_offset(t, off):
        buf = torch.empty(t.numel() + off, dtype=t.dtype)
        out = buf[off:].view(t.shape)
        out.copy_(t)
        return out

    model = make_deepfm(vocabulary=vocab, dim=9)
    trainer = Trainer(model, opt, device="cpu")
    batch = next(data.synthetic_criteo(256, id_space=vocab, seed=7))
    state0 = trainer.init(batch)
    threads = torch.get_num_threads()
    runs = {}
    try:
        for nt, off in ((threads, 0), (1, 1), (3, 3)):
            torch.set_num_threads(nt)
            w, accum = at_offset(w0, off), at_offset(accum0, off)
            apply.fused_sparse_apply_reference(opt, w, {"accum": accum},
                                               idx, g, counts)
            state = state0.clone()
            for _ in range(3):
                state, _ = trainer.train_step(state, batch)
            runs[nt, off] = {"w": w, "accum": accum,
                             **microbench.state_bits(state)}
    finally:
        torch.set_num_threads(threads)
    want = runs[threads, 0]
    for key, got in runs.items():
        for k in want:
            assert torch.equal(microbench.bits(got[k]),
                               microbench.bits(want[k])), (key, k)


def test_planted_mismatch_raises(monkeypatch, capsys):
    def off_by_one(weights, rows, **kw):
        return gather_windows.gather_rows_windows_reference(
            weights, rows, **kw) + 1

    monkeypatch.setattr(gather_windows, "gather_rows_windows", off_by_one)
    with pytest.raises(microbench.MismatchError,
                       match="gather_rows_windows dim 64"):
        microbench.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert '"bench": "gather_windows"' not in out  # stopped, printed nothing


def test_planted_gather_mismatch_raises(monkeypatch):
    real = gather.gather_rows_reference

    def flipped(weights, rows, valid=None):
        out = real(weights, rows, valid)
        return torch.where(out == 0, out, -out)

    monkeypatch.setattr(gather, "gather_rows", flipped)
    with pytest.raises(microbench.MismatchError, match="gather_rows dim 64"):
        microbench.main(["--device", "cpu"])
