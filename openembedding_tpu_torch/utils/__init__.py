"""Host-side utilities of the port (port of `openembedding_tpu/utils/`;
only `metrics.auc` so far, the rest is ROADMAP.md items 6 and 7)."""
