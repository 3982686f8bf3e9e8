"""`test_torch_pipeline.py`'s pipelined windows with hot rows and with
migration, array tables at the fp32 wire, S = 2 (what is compared and
the bounds: that file's docstring)."""

from test_torch_pipeline import H, M, window_tests

windows, test_pipelined_window_equals_serial_and_matches_jax = window_tests(
    2, {"hot": {"hot_rows": H}, "mig": {"mig_rows": M}})
