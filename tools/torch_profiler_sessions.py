"""How often a torch.profiler session loses device records on the card.

Runs `chip_smoke.py`'s phases up to and including the example phase, as
its `main` does. At each of the script's profiler checks (the window
gather's and the apply's one-kernel calls, the `--cache` eager step) it
first takes 10 sessions of each kind in turns (`chip_smoke.profiled_session`
opened by 0, 1, 8 and 32 short spins) and prints, for each check and
kind, how many sessions traced (brackets, opening spins, gathers): the two
bracket spins around the call, the short spins and the gather kernel.
Then the check runs as in the script.

Run from the repo root on a machine with a CUDA card (about 2 minutes):

    python3 tools/torch_profiler_sessions.py
"""
import collections
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

TURNS = 10
KINDS = (0, 1, 8, 32)  # opening spins
_device_kernels = cs.device_kernels
_checks = []


def device_kernels(torch, fn, tries: int = 5) -> tuple:
    seen = {kind: collections.Counter() for kind in KINDS}
    for i in range(len(KINDS) * TURNS):
        kind = KINDS[i % len(KINDS)]
        traced = cs.profiled_session(torch, fn, kind)
        gathers = sum("gather_rows_kernel" in name for name, _ in traced)
        spins = sum("spin" in name for name, _ in traced)
        brackets = cs.bracket_spins(traced)
        seen[kind][str((brackets, spins - brackets, gathers))] += 1
    _checks.append(seen)
    print(json.dumps({"check": len(_checks),
                      **{f"opening {kind}": dict(seen[kind])
                         for kind in KINDS}}), flush=True)
    return _device_kernels(torch, fn, tries)


def main():
    import torch
    from openembedding_tpu_torch import data, microbench as mb, optimizers
    from openembedding_tpu_torch import ops
    from openembedding_tpu_torch.ops import (_build, apply, gather,
                                             gather_windows, sparse)
    cs.device_kernels = device_kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build(torch, (gather, gather_windows, apply), _build)
    cs.phase_kernel(torch, mb, gather)
    _, profile_calls = cs.phase_windows(torch, mb, gather, gather_windows,
                                        sparse, data)
    torch.cuda.empty_cache()
    _, apply_calls = cs.phase_apply(torch, mb, apply, gather, sparse,
                                    optimizers, data)
    cs.kernels_profile(torch, "windows", profile_calls, "window_gather")
    cs.kernels_profile(torch, "apply", apply_calls, "fused_apply")
    del profile_calls, apply_calls
    torch.cuda.empty_cache()
    cs.phase_serve(torch, ops, gather)
    cs.phase_train(torch, mb, ops, optimizers, data)
    torch.cuda.empty_cache()
    cs.phase_example(torch, mb, ops, data, optimizers)
    total = {kind: collections.Counter() for kind in KINDS}
    for seen in _checks:
        for kind in total:
            total[kind].update(seen[kind])
    print(json.dumps({"checks": len(_checks),
                      **{f"opening {kind}": dict(total[kind])
                         for kind in KINDS}}), flush=True)


if __name__ == "__main__":
    main()
