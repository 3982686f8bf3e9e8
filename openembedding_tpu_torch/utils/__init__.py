"""Host-side utilities of the port (port of `openembedding_tpu/utils/`):
the metrics registry (`metrics`), spans and the flight recorder (`trace`),
metric history rings (`history`), SLOs (`slo`), postmortem capsules
(`capsule`), heavy-hitter sketches (`sketch`), sampled step timing
(`stepwatch`), the train step's phases timed on the device (`phases`),
the device-memory ledger (`memwatch`), remote storage
URIs (`fs`) and the runtime guards (`guards`: no CUDA-graph re-capture,
a fixed collective sequence)."""

from . import metrics, trace
from .metrics import (Accumulator, vtimer, report, report_table,
                      prometheus_text, PeriodicReporter)
from .trace import span, dump_chrome

__all__ = ["metrics", "trace", "Accumulator", "vtimer", "report",
           "report_table", "prometheus_text", "PeriodicReporter", "span",
           "dump_chrome"]
