"""Input pipelines of the port: the Criteo readers (native and Python
engines), the synthetic and planted-signal generators, the rebatcher and the
device prefetcher (port of `openembedding_tpu/data/`; `data/ingest.py` is
ROADMAP.md item 7)."""

from .criteo import (NUM_DENSE, NUM_SPARSE, CriteoBatcher,
                     criteo_fold_offsets, hash_category, is_ragged,
                     pad_ragged, planted_criteo, planted_logit,
                     prefetch_to_device, read_criteo_csv,
                     read_criteo_tfrecord, read_criteo_tsv, synthetic_criteo)

__all__ = ["NUM_DENSE", "NUM_SPARSE", "CriteoBatcher", "criteo_fold_offsets",
           "hash_category", "is_ragged", "pad_ragged", "planted_criteo",
           "planted_logit", "prefetch_to_device", "read_criteo_csv",
           "read_criteo_tfrecord", "read_criteo_tsv", "synthetic_criteo"]
