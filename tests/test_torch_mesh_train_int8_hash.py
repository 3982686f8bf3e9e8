"""`test_torch_mesh_train_int8.py`'s trajectories: the int8 wire with every
mechanism, hash tables at S = 2 (configurations and tolerances: that file's
docstring)."""

from test_torch_mesh_train_int8 import INT8_ALL, trajectory_tests

runs, test_ten_steps_with_placement_match_the_jax_mesh_trainer = \
    trajectory_tests(2, "hash", INT8_ALL)
