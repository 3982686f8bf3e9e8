"""`test_torch_pipeline.py`'s pipelined windows on hash tables (a 2^40 id
space into 4,096 slots) with hot rows and migration at S = 4, at the
fp32 wire and at the int8 wire with error feedback and the int8 hot
reduce. The prefetch inserts each batch's ids a step ahead, in the
serial order, and the patch re-gathers without inserting, so keys,
overflow counters and rows equal the serial window's bit for bit. The
int8 case runs in `test_torch_pipeline_int8_s4_hash.py` (a file each
keeps a file's run well under 40 s)."""

from test_torch_pipeline import H, M, window_tests

windows, test_pipelined_window_equals_serial_and_matches_jax = window_tests(
    4, {"fp32_hot_mig": {"hashed": True, "hot_rows": H, "mig_rows": M}})
