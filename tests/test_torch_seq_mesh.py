"""The port's `SeqMeshTrainer` against the JAX package's on a (2, 2)
(data, seq) mesh: SASRec with ring attention here, BERT4Rec in
`test_torch_seq_mesh_bert4rec.py`, Ulysses attention in
`test_torch_seq_mesh_ulysses*.py` (a file each keeps a file under 40 s),
the checkpoints and the export in `test_torch_seq_mesh_io.py`.

SASRec and BERT4Rec at VOCAB 512, DIM 16, SEQ 32, 2 heads, 2 blocks,
float32, Adagrad(0.1), batches of 8: the JAX SeqMeshTrainer on 4 virtual
devices reshaped (2, 2), the port on 4 gloo ranks (`multihost.run_local`,
`make_seq_mesh(2, 2)`: rank d*2 + s takes rows [4d, 4d+4) and positions
[16s, 16s+16) of each batch), each from the JAX init carried across by
`convert.mesh_state_from_jax` (tables sharded id % 4 over the whole
mesh). Checked: the eval logits and loss on the first batch, the loss
normalized by the mask count of the whole mesh (equal to the single-device
full-attention loss of the same batch and state), four steps' losses and
logits, and the state after them. Tolerances (the largest deviation
measured over both attentions and families in brackets): eval logits 1e-6
(8e-8), step logits 5e-6 (7e-7), losses 2e-6 (7e-7 against the single
device), tables 2e-6 (1.8e-7), dense params 2e-6 (1.2e-7): the ranks'
dense sums in rank order against XLA's all-reduce, and softmax orders of
adds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import openembedding_tpu as jembed
from openembedding_tpu.model import Trainer as JaxTrainer
from openembedding_tpu.models import make_bert4rec as jax_make_bert4rec
from openembedding_tpu.models import make_sasrec as jax_make_sasrec
from openembedding_tpu.parallel import SeqMeshTrainer as JaxSeqMeshTrainer
from openembedding_tpu.parallel import deinterleave_rows
from openembedding_tpu_torch import convert
from openembedding_tpu_torch.parallel.multihost import run_local

from test_torch_mesh_train import numpy_state
from test_torch_sequential import _batches
import torch_seq_ranks as ranks

VOCAB, DIM, SEQ, HEADS, BATCH, STEPS = 512, 16, 32, 2, 8, 4
SHAPE = (2, 2)
TOL = {"logits": 1e-6, "step_logits": 5e-6, "loss": 2e-6, "table": 2e-6,
       "dense": 2e-6}


def jax_mesh():
    return Mesh(np.array(jax.devices()[:4]).reshape(SHAPE), ("data", "seq"))


def jax_model(family, attention):
    make = jax_make_bert4rec if family == "bert4rec" else jax_make_sasrec
    return make(VOCAB, DIM, num_heads=HEADS, attention=attention,
                compute_dtype=jnp.float32)


def rows_of(family):
    return VOCAB + (family == "bert4rec")


def jax_run(family, attention, steps=STEPS):
    """The JAX SeqMeshTrainer's `steps` steps (the first one's logits and
    loss are the initial state's eval), and the single-device full-attention loss of the first batch from the
    same state -> (port config, JAX results)."""
    batches = _batches(family, steps, batch=BATCH, seed=11)
    tr = JaxSeqMeshTrainer(jax_model(family, attention),
                           jembed.Adagrad(learning_rate=0.1),
                           mesh=jax_mesh(), seed=7, wire="fp32")
    state = tr.init(batches[0])
    start = numpy_state(state)
    one = JaxTrainer(jax_model(family, "full"),
                     jembed.Adagrad(learning_rate=0.1), seed=7)
    s1 = one.init(batches[0])
    t = state.tables["item"]
    s1 = s1.replace(dense_params=jax.device_get(state.dense_params),
                    tables={"item": s1.tables["item"].replace(
                        weights=jnp.asarray(deinterleave_rows(
                            np.asarray(t.weights), 4, rows_of(family))))})
    single_loss = float(jax.jit(one.eval_step)(s1, batches[0])["loss"])
    step = tr.jit_train_step(batches[0], state)
    losses, logits = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        logits.append(np.asarray(m["logits"]))
    cfg = {"shape": SHAPE, "family": family, "vocab": VOCAB, "dim": DIM,
           "heads": HEADS, "attention": attention, "optimizer": "adagrad",
           "lr": 0.1, "state": start, "batches": batches}
    # the first step's logits and loss are the initial state's
    return cfg, {"eval_logits": logits[0], "eval_loss": losses[0],
                 "single_loss": single_loss,
                 "losses": losses, "logits": logits,
                 "state": numpy_state(state)}


def assemble(blocks):
    """The ranks' (B/2, S/2, ...) blocks in rank order -> (B, S, ...)."""
    D, P = SHAPE
    rows = [np.concatenate(blocks[d * P:(d + 1) * P], axis=1)
            for d in range(D)]
    return np.concatenate(rows, axis=0)


def check_run(want, port):
    np.testing.assert_allclose(
        assemble([p["eval"]["logits"] for p in port]), want["eval_logits"],
        rtol=0, atol=TOL["logits"])
    for p in port:
        # the loss of the whole mesh: every rank reports the same sum
        np.testing.assert_allclose(float(p["eval"]["loss"]),
                                   want["eval_loss"], rtol=0,
                                   atol=TOL["loss"])
        np.testing.assert_allclose(float(p["eval"]["loss"]),
                                   want["single_loss"], rtol=0,
                                   atol=TOL["loss"])
        np.testing.assert_allclose(p["losses"], want["losses"], rtol=0,
                                   atol=TOL["loss"])
    for k in range(STEPS):
        np.testing.assert_allclose(
            assemble([p["logits"][k] for p in port]), want["logits"][k],
            rtol=0, atol=TOL["step_logits"], err_msg=f"step {k}")
    got = convert.mesh_state_to_jax([p["state"] for p in port])
    ref = want["state"]
    assert got["step"] == ref["step"] == STEPS
    np.testing.assert_allclose(got["tables"]["item"]["weights"],
                               ref["tables"]["item"]["weights"], rtol=0,
                               atol=TOL["table"])
    for k, v in ref["dense_params"].items():
        np.testing.assert_allclose(got["dense_params"][k], v, rtol=0,
                                   atol=TOL["dense"], err_msg=k)


def seq_mesh_tests(attention, family):
    """(the module fixture, the test) of one attention and family: the
    JAX run, then the port's four ranks (one launch), compared."""
    families = [family]

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        jax_runs = [jax_run(f, attention) for f in families]
        port = run_local(ranks.trajectories, 4,
                         args=([cfg for cfg, _ in jax_runs],), timeout_s=120,
                         tmp_dir=str(tmp_path_factory.mktemp("ranks")))
        return jax_runs, port

    @pytest.mark.parametrize("family", families)
    def test_matches_the_jax_seq_mesh_trainer(runs, family):
        jax_runs, port = runs
        i = families.index(family)
        check_run(jax_runs[i][1], [port[r][i] for r in range(4)])

    return runs, test_matches_the_jax_seq_mesh_trainer


runs, test_ring_matches_the_jax_seq_mesh_trainer = seq_mesh_tests(
    "ring", "sasrec")


def test_needs_a_two_dimensional_mesh():
    import torch
    from openembedding_tpu_torch.models import make_sasrec
    from openembedding_tpu_torch.parallel import Mesh, SeqMeshTrainer
    flat = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                backend="gloo")
    with pytest.raises(ValueError, match="2-D"):
        SeqMeshTrainer(make_sasrec(VOCAB, DIM, attention="ring"), mesh=flat)


def test_local_batch_blocks_follow_the_jax_pspec():
    """`multihost.local_batch` on the (2, 2) mesh gives rank d*2 + s the
    block JAX's `_batch_pspec` puts on device (d, s): ids (data, ..., seq),
    a 2-D label (data, seq), dense and weight over data only."""
    import torch
    from jax.sharding import NamedSharding
    from openembedding_tpu_torch.parallel import Mesh
    from openembedding_tpu_torch.parallel.multihost import local_batch
    rng = np.random.default_rng(0)
    batch = {"sparse": {"item": rng.integers(0, 99, (8, 3, SEQ))},
             "label": rng.random((8, SEQ)).astype(np.float32),
             "dense": rng.random((8, 5)).astype(np.float32),
             "weight": rng.random(8).astype(np.float32)}
    mesh = jax_mesh()
    tr = JaxSeqMeshTrainer(jax_model("sasrec", "ring"),
                           jembed.Adagrad(learning_rate=0.1), mesh=mesh,
                           wire="fp32")
    spec = tr._batch_pspec(batch)
    placed = jax.tree.map(lambda x, p: jax.device_put(
        x, NamedSharding(mesh, p)), batch, spec)
    for d in range(2):
        for s in range(2):
            dev = mesh.devices[d, s]
            rank = Mesh(group=None, rank=d * 2 + s, size=4,
                        device=torch.device("cpu"), backend="gloo",
                        axis_names=("data", "seq"), shape=SHAPE)
            got = local_batch(batch, rank)
            want = jax.tree.map(lambda a: np.asarray(next(
                sh.data for sh in a.addressable_shards if sh.device == dev)),
                placed)
            for key in ("label", "dense", "weight"):
                np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_array_equal(got["sparse"]["item"],
                                          want["sparse"]["item"])
