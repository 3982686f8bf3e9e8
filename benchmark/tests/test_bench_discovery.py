"""The harness finds configurations, mixes and per-layer metrics by name, and
a file added without an edit is picked up."""

import json
import os

from benchmark import spec


def test_every_cell_resolves_to_its_files():
    bench = spec.load()
    for wl in bench["workloads"]:
        parts = spec.cell_parts(bench, wl["name"])
        assert parts["config"]["name"] == wl["config"]
        assert parts["traffic"]["generator"]
        for m in spec.per_layer(bench, wl["name"]):
            assert callable(spec.reader(m["name"]).read)
        e2e = {m["name"] for m in spec.end_to_end(bench, wl["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2


def test_per_layer_rules():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["y"]}],
             "per_layer": [{"name": "p", "moves": "a"},
                           {"name": "q", "moves": "b"},
                           {"name": "r", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in spec.per_layer(bench, "x")] == ["p"]
    assert [m["name"] for m in spec.per_layer(bench, "y")] == ["p", "q", "r"]


def test_added_files_are_found_without_an_edit(tiny):
    root = tiny
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(bdir, "configs", "deepfm_d9.json")) as f:
        cfg = json.load(f)
    cfg["dim"] = 4
    with open(os.path.join(bdir, "configs", "deepfm_d4.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bdir, "traffic", "criteo_zipf.json")) as f:
        mix = json.load(f)
    mix["alpha"] = 1.2
    with open(os.path.join(bdir, "traffic", "criteo_flat.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bdir, "metrics", "pool_unique.py"), "w") as f:
        f.write("def read(ctx):\n    return float(max(ctx.unique))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "deepfm_d4", "source": "x",
                             "file": "benchmark/configs/deepfm_d4.json",
                             "reduced": ["dim"], "why": "x"})
    bench["workloads"].append({"name": "deepfm_d4.flat",
                               "config": "deepfm_d4",
                               "traffic": "criteo_flat", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "pool_unique", "unit": "ids",
                               "better": "lower", "source": "host_clock",
                               "layer": "traffic", "moves": "examples_per_s",
                               "workloads": ["deepfm_d4.flat"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    bench = spec.load(root)
    parts = spec.cell_parts(bench, "deepfm_d4.flat", root, bdir)
    assert parts["config"]["dim"] == 4
    assert parts["traffic"]["alpha"] == 1.2
    names = [m["name"] for m in spec.per_layer(bench, "deepfm_d4.flat")]
    assert "pool_unique" in names

    class Ctx:
        unique = [3, 7]
    assert spec.reader("pool_unique", bdir).read(Ctx) == 7.0
    assert "pool_unique" not in [
        m["name"] for m in spec.per_layer(bench, "deepfm_d9.train")]


def test_reduced_keys_are_in_their_configuration_files():
    bench = spec.load()
    for entry in bench["configs"]:
        cfg = spec.config(bench, entry["name"])
        for key in entry["reduced"]:
            assert key in cfg, (entry["name"], key)
            assert key in cfg.get("published", {}), (entry["name"], key)
