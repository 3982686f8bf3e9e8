"""`test_torch_mesh_train_int8.py`'s trajectories: fp32 hot rows with
migration, hash tables at S = 4 (configurations and tolerances: that file's
docstring)."""

from test_torch_mesh_train_int8 import FP32_ALL, trajectory_tests

runs, test_ten_steps_with_placement_match_the_jax_mesh_trainer = \
    trajectory_tests(4, "hash", FP32_ALL)
