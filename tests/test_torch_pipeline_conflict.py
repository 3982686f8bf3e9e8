"""`test_torch_pipeline.py`'s pipelined windows where the conflict patch
is at its edges, array tables at the fp32 wire (what is compared and the
bounds: that file's docstring):

- a window of one batch: no step ahead, so no patch; zero conflicts, and
  bit-equal to the serial window;
- planted overlap (every batch shares batch 0's first 8 rows): the patch
  repairs rows, as many as the JAX window's;
- a capped patch (`conflict_factor=0.05`): members past the cap keep
  their prefetched rows, as many as the JAX window's, which leaves the
  serial window as the JAX window does; against the JAX window the fp32
  bounds hold.

One rank: `test_torch_pipeline_one_rank.py`.
"""

from test_torch_pipeline import window_tests

windows, test_pipelined_window_equals_serial_and_matches_jax = window_tests(
    2, {"one_batch": {"k": 1}, "overlap": {"overlap": True},
        "capped": {"overlap": True, "conflict_factor": 0.05}})

