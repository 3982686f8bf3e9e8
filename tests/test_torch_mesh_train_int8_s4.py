"""`test_torch_mesh_train_int8.py`'s trajectories: the int8 wire with every
mechanism, array tables at S = 4 (configurations and tolerances: that
file's docstring)."""

from test_torch_mesh_train_int8 import INT8_ALL, trajectory_tests

runs, test_ten_steps_with_placement_match_the_jax_mesh_trainer = \
    trajectory_tests(4, "array", INT8_ALL)
