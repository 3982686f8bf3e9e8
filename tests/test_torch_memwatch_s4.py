"""`test_torch_memwatch.py`'s memory-model cases on 4 gloo ranks (against
the JAX MeshTrainer on 4 devices); a file of its own keeps each under
40 s."""

from test_torch_memwatch import memory_model_tests

runs, test_memory_model_analytic_equals_measured_and_jax = \
    memory_model_tests(4)
