"""`/statusz` over the port's REST server with a live placement controller
and a published memory ledger (2 gloo ranks; rank 0 serves).

The page's "-- placement (self-driving) --" panel is `render_status()`
with the controller's `hot_rows=`, `migrations_applied=` and
`last_refresh=step` lines, and its "-- device memory (memwatch ledger)
--" panel lists every ledger component in the JAX server's format
(`component{table=...}: N,NNNB`) and the model's device total, as the JAX
package's `serving.py` renders them."""

import numpy as np

from openembedding_tpu.placement.policy import row_bytes
from openembedding_tpu_torch.parallel.multihost import run_local

import torch_placement_ranks as ranks

T = ranks.TABLE


def test_statusz_renders_memory_and_placement_panels(tmp_path):
    reg = tmp_path / "registry"
    reg.mkdir()
    cfg = {"vocab": 1 << 12, "lr": 0.05, "k": 64, "decay": 0.85,
           "budget": 8 * row_bytes(10, 1), "mig_rows": 32, "cooldown": 3,
           "target": 1.05, "interval": 3, "H": 8,
           "batches": ranks.drift_batches(2, 4), "registry": str(reg)}
    # the port's own init in place of the JAX state: the panels only
    from openembedding_tpu_torch import convert, optimizers
    from openembedding_tpu_torch.model import Trainer
    model = ranks.model_of(cfg)
    single = Trainer(model, optimizers.Adagrad(learning_rate=0.05),
                     device="cpu")
    state = single.init(cfg["batches"][0])
    js = convert.train_state_to_jax(state)
    # one device's table is the two-shard table relaid shard-major
    from openembedding_tpu_torch.parallel.sharded import interleave_rows
    for t in js["tables"].values():
        t["weights"] = interleave_rows(t["weights"], 2)
        t["slots"] = {k: interleave_rows(v, 2) for k, v in t["slots"].items()}
    cfg["state"] = js
    out = run_local(ranks.statusz_run, 2, args=(cfg,), timeout_s=120,
                    tmp_dir=str(tmp_path))[0]
    page = out["page"]
    place = page.split("-- placement (self-driving) --\n")[1].split(
        "\n\n")[0]
    assert place == out["render"]
    assert "controller: step=8 primed=True" in place
    assert f"table {T}: hot_rows=8" in place
    assert "migrations_applied=" in place and "last_refresh=step" in place
    mem = page.split("-- device memory (memwatch ledger) --\n")[1].split(
        "\n\n")[0].splitlines()
    comps = out["export"]["components"]
    assert len(mem) == len(comps) + 1
    for e in comps:
        lbl = ",".join(f"{k}={v}" for k, v in sorted(e["labels"].items()))
        tag = e["component"] + (f"{{{lbl}}}" if lbl else "")
        assert f"{tag}: {e['bytes']:,}B" in mem
    assert {e["component"] for e in comps} >= {
        "table_weights", "table_slots", "hot", "mig", "dense_params",
        "dense_slots"}
    assert mem[-1] == (f"device total (model): "
                       f"{out['export']['device_total_bytes']:,}B")
    assert np.isfinite(out["export"]["device_total_bytes"])
