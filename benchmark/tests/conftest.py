"""Shared pieces of the benchmark's CPU tests: a copy of the benchmark cut to
a size the CPU runs in seconds."""

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the sizes a CPU test trains at; the widths of the tower shrink with them
TINY_CONFIG = {"hidden": [16, 16]}
TINY_VOCABULARY = 4096
TINY_CAPACITY = 1 << 14
TINY_MIX = {"batch_size": 64, "window": 4, "pool_batches": 16,
            "stray_rows": 256}


def tiny_copy(dest) -> str:
    """`BENCHMARK.json` and the benchmark's folder copied under `dest`, every
    configuration and mix cut to the tiny sizes, the limits kept -> the
    copy's root."""
    root = str(dest)
    shutil.copytree(BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(TINY_CONFIG)
        if cfg["hashed"]:
            cfg["capacity"] = TINY_CAPACITY
        else:
            cfg["vocabulary"] = TINY_VOCABULARY
        with open(path, "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(root, "benchmark", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            mix = json.load(f)
        mix.update(TINY_MIX)
        with open(path, "w") as f:
            json.dump(mix, f)
    return root


@pytest.fixture
def tiny(tmp_path):
    return tiny_copy(tmp_path)

