"""The port's ingest soak (`python -m openembedding_tpu_torch.ingest_soak`)
at a CPU size against the JAX package's `tools/ingest_soak.py`: the same
report keys (the port adds `device` and `captures`), its copy of the
ingest SLO equal to `tools/ingest_slo.json`, the soak's own invariants
(the pooled reader bit-identical to the inline one, the throttled control
input-bound), and the exit code: the SLO verdict, 0 under
`--no-slo-gate`."""

import importlib.util
import json
import os

import pytest

from openembedding_tpu_torch import ingest_soak

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
SMALL = dict(windows=2, window=2, batch=64, vocab=1 << 10, quiet=True)


def _jax_soak():
    spec = importlib.util.spec_from_file_location(
        "jax_ingest_soak", os.path.join(TOOLS, "ingest_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "slo":
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.fixture(scope="module")
def reports():
    want = _jax_soak().run(devices=2, **SMALL)
    got = ingest_soak.run(device="cpu", **SMALL)
    return got, want


def test_report_keys_match_the_jax_tool(reports):
    got, want = reports
    assert _keys(got) - {"device", "captures"} == _keys(want)
    assert set(got["slo"]) == set(want["slo"]) == {"input_wait_share"}
    assert got["windows"] == want["windows"] == SMALL["windows"]
    assert got["throttled"]["windows"] == SMALL["windows"]
    assert got["num_shards"] == 1 and got["device"] == "cpu"


def test_the_soak_invariants_hold(reports):
    got, _ = reports
    assert got["reader_pool_bit_identical"]
    share = got["line_rate"]["input_wait_share"]
    tshare = got["throttled"]["input_wait_share"]
    assert 0 <= share < tshare and tshare > 0.25
    assert got["compute_ms_per_step"] > 0
    assert got["slo_exit_code"] == (0 if share <= 0.05 else 1)


def test_slo_spec_is_the_tools_copy():
    with open(os.path.join(TOOLS, "ingest_slo.json")) as f:
        assert ingest_soak.SLO_SPECS == json.load(f)


def test_main_exit_code_and_report_line(capsys):
    rc = ingest_soak.main(["--device", "cpu", "--windows", "2", "--window",
                           "2", "--batch", "32", "--vocab", "512",
                           "--no-slo-gate"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["windows"] == 2 and report["batch"] == 32
