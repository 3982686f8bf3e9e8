"""Nothing the run or the reference imports is `jax` or the JAX package, by
whole top-level name, and the reference imports nothing of the program."""

import os
import subprocess
import sys
import textwrap

from benchmark import run
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _fresh(code: str) -> str:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, capture_output=True, text=True,
                          check=True).stdout


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "openembedding_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_x", object())
    names = set(run.forbidden_modules())
    assert "openembedding_tpu_torch_x" not in names
    monkeypatch.setitem(sys.modules, "openembedding_tpu.sub", object())
    assert "openembedding_tpu" in run.forbidden_modules()


def test_run_and_program_load_no_jax():
    out = _fresh("""
        import sys
        sys.path.insert(0, ".")
        import benchmark.run, benchmark.program, benchmark.calibrate
        from benchmark import spec
        for m in spec.load()["per_layer"]:
            spec.reader(m["name"])
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    tops = eval(out)
    assert "openembedding_tpu_torch" in tops
    for bad in run.FORBIDDEN:
        assert bad not in tops


def test_reference_loads_nothing_of_the_program():
    out = _fresh("""
        import sys
        sys.path.insert(0, ".")
        import benchmark.reference.deepfm, benchmark.reference.weights
        import benchmark.judge, benchmark.traffic, benchmark.costs
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    tops = eval(out)
    for bad in run.FORBIDDEN + ("openembedding_tpu_torch",):
        assert bad not in tops
