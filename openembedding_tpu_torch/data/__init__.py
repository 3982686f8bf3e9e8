"""Input pipelines of the port (port of `openembedding_tpu/data/`): the
Criteo readers (native and Python engines; the TSV reader streams URIs of a
registered filesystem, `utils/fs`), the synthetic and planted-signal
generators, the rebatcher, the device prefetcher, and the line-rate ingest
path (`data/ingest.py`: per-node file-sharded streaming, a parse pool with
a reorder stage, a depth-D device feed ring)."""

from .criteo import (NUM_DENSE, NUM_SPARSE, CriteoBatcher,
                     criteo_fold_offsets, hash_category, is_ragged,
                     pad_ragged, planted_criteo, planted_logit,
                     prefetch_to_device, read_criteo_csv,
                     read_criteo_tfrecord, read_criteo_tsv, synthetic_criteo)
from .ingest import (FeedRing, ParsePool, feed, input_wait_share,
                     register_source, ring_shard, sharded_files,
                     sharded_reader)

__all__ = ["NUM_DENSE", "NUM_SPARSE", "CriteoBatcher", "criteo_fold_offsets",
           "hash_category", "is_ragged", "pad_ragged", "planted_criteo",
           "planted_logit", "prefetch_to_device", "read_criteo_csv",
           "read_criteo_tfrecord", "read_criteo_tsv", "synthetic_criteo",
           "FeedRing", "ParsePool", "feed", "input_wait_share",
           "register_source", "ring_shard", "sharded_files",
           "sharded_reader"]
