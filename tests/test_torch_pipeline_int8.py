"""`test_torch_pipeline.py`'s pipelined windows at the int8 wire with
error feedback, array tables at S = 2: batches as drawn ("disjoint": no
planted overlap), planted overlap, and planted overlap with hot rows,
migration and the int8 hot reduce. A prefetched row is stale in both its
value and its residual where the previous apply wrote; the conflict patch
replays the serve from the stashed residual, so the pipelined window
equals the serial one bit for bit, residuals included
(`tests/test_pipeline.py`'s int8 pin of the JAX package). Against the JAX
window: `test_torch_mesh_train_int8.py`'s int8 bounds."""

from test_torch_pipeline import window_tests

windows, test_pipelined_window_equals_serial_and_matches_jax = window_tests(
    2, {"disjoint": {"wire": "int8"},
        "overlap": {"wire": "int8", "overlap": True}})
