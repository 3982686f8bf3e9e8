"""`test_torch_mesh_train.py`'s 10-step trajectories against the JAX
MeshTrainer, its hash table configurations at S = 4 (its docstring
states the configurations and the tolerances)."""

from test_torch_mesh_train import trajectory_tests

runs, test_ten_steps_match_the_jax_mesh_trainer = trajectory_tests(4,
                                                                   "hash")
