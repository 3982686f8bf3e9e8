"""`test_torch_pipeline_s4_hash.py`'s int8 case: hash tables with hot
rows, migration and the int8 hot reduce at S = 4, the int8 wire with
error feedback (what is compared and the bounds: that file's and
`test_torch_pipeline.py`'s docstrings)."""

from test_torch_pipeline import H, M, window_tests

windows, test_pipelined_window_equals_serial_and_matches_jax = window_tests(
    4, {"int8_hot_mig": {"hashed": True, "wire": "int8", "hot_rows": H,
                         "mig_rows": M, "hot_wire": "int8"}})
