"""`test_torch_hot.py`'s one-step hot-row cases on four port ranks against
the JAX mesh of four devices (tolerances: that file's docstring)."""

from test_torch_hot import one_step_test

runs, test_one_step_with_hot_rows_matches_the_jax_mesh = one_step_test(4)
