"""`test_torch_mesh_train_int8.py`'s trajectories: fp32 hot rows and fp32
migration, array tables at S = 2 (configurations and tolerances: that
file's docstring)."""

from test_torch_mesh_train_int8 import FP32_HOT, FP32_MIG, trajectory_tests

runs, test_ten_steps_with_placement_match_the_jax_mesh_trainer = \
    trajectory_tests(2, "array", FP32_HOT + FP32_MIG)
