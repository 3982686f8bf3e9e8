"""`test_torch_pipeline_int8.py`'s third case: planted overlap with hot
rows, migration and the int8 hot reduce, at the int8 wire with error
feedback, array tables at S = 2 (what is compared and the bounds: that
file's and `test_torch_pipeline.py`'s docstrings)."""

from test_torch_pipeline import H, M, window_tests

windows, test_pipelined_window_equals_serial_and_matches_jax = window_tests(
    2, {"overlap_hot_mig": {"wire": "int8", "overlap": True, "hot_rows": H,
                            "mig_rows": M, "hot_wire": "int8"}})
