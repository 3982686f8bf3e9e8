"""Every CTR family of the zoo through the port's Criteo entry point
(`python -m openembedding_tpu_torch.examples.criteo_deepctr --model F`) on
the CPU, at the JAX entry point's default widths on `examples/train100.tsv`
(vocabulary 1000, batches of 32): the model is the family's, its table
`--dim` + 1 wide (LR's 1 wide: LR takes no `--dim`), the export serves it,
and the eager and graph drivers (the CPU runs the graph driver's eager
step) agree bit for bit."""

import os

import numpy as np
import pytest
import torch

from openembedding_tpu_torch.examples import criteo_deepctr
from openembedding_tpu_torch.export import StandaloneModel
from openembedding_tpu_torch.models import ctr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN100 = os.path.join(REPO, "examples", "train100.tsv")
BASE = ["--device", "cpu", "--data", TRAIN100, "--batch-size", "32",
        "--vocabulary", "1000", "--dim", "9", "--steps", "3"]
MODULES = {"lr": ctr.LogisticRegression, "wdl": ctr.WideDeep,
           "xdeepfm": ctr.XDeepFM, "dcn": ctr.DCN, "dlrm": ctr.DLRM}


@pytest.mark.parametrize("family", sorted(MODULES))
def test_main_trains_and_exports_every_family(family, tmp_path):
    export = str(tmp_path / "export")
    eager = criteo_deepctr.main(BASE + ["--model", family, "--eager",
                                        "--export", export])
    graph = criteo_deepctr.main(BASE + ["--model", family])
    assert isinstance(eager["model"].module, MODULES[family])
    assert eager["model"].config["family"] == family
    width = 1 if family == "lr" else 10
    assert eager["state"].tables["categorical"].weights.shape == (1000, width)
    assert np.isfinite(eager["losses"]).all()
    np.testing.assert_array_equal(graph["losses"], eager["losses"])
    served = StandaloneModel.load(export, device="cpu")
    batch = {"sparse": {"categorical": np.arange(26 * 4).reshape(4, 26)
                        % 1000},
             "dense": np.ones((4, 13), np.float32), "label": np.zeros(4)}
    assert torch.equal(served.predict(batch), eager["trainer"].eval_step(
        eager["state"], batch)["logits"])
