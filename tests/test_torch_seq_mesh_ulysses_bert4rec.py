"""The port's `SeqMeshTrainer` against the JAX package's on a (2, 2)
mesh: BERT4Rec with Ulysses attention (the key-padding mask
all_gathered along the seq axis); `test_torch_seq_mesh.py`'s checks and tolerances."""

from test_torch_seq_mesh import seq_mesh_tests

runs, test_matches_the_jax_seq_mesh_trainer = seq_mesh_tests(
    "ulysses", "bert4rec")
