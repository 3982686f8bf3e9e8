"""Runnable examples of the port (`python -m openembedding_tpu_torch.examples.<name>`)."""
