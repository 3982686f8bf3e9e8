#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`openembedding_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises, exits non-zero and skips the
final line:

1. device  — the card's name and power limit (nvidia-smi), CUDA present;
2. build   — nvcc builds the three kernels, `csrc/gather_rows.cu`,
   `csrc/gather_rows_windows.cu` and `csrc/fused_sparse_apply.cu` (all
   three include the row-copy core's lane map `csrc/gather_core.cuh`), at
   the same time (one thread each); ptxas's registers and spills per kernel
   instance, the grids of the gather and of every apply instance (resident
   blocks, read once per card), a check that the window kernel's staging
   constants are the ones `ops/gather_windows.staged_bytes` mirrors, and
   one that `ops/apply.launch_plan` picks the kernel's word and tile
   (`oe_fused_sparse_apply_plan`) for every rule, widths 1 to 1024, both
   table types, and addresses and strides off every word boundary;
3. kernel  — the gather against its plain PyTorch version on the card at the
   serving path's shapes (a 2^24 x 10 float32 table, 4096 x 26 Zipfian ids
   with -1 pads and out-of-range ids; int32/int64 ids, with and without a
   mask; one bfloat16 table of width 64) and at the row-copy core's edges:
   rows of 36 bytes (float32 width 9) and 18 bytes (bfloat16 width 9), a
   table view 8-byte aligned (`w[1:]`), n not a multiple of the tile, and
   n = 1 (the floor of one launch). Every case must be bit-equal. Times:
   the kernel, the plain version, and one library call computing the same
   function (index_select + where, a yardstick the port never calls),
   beside the memory bound at 3.35 TB/s;
4. windows — the window-batched gather (one launch, no prepass) against
   its plain version and against the gather kernel, bit-equal, on the
   2^24 x 10 table with the sorted ids the dedup emits for one
   `synthetic_criteo(4096, id_space=2^24, seed=7)` batch (windows 16 and
   64), the dedup's ids of Zipf(1.1) ranks left unhashed
   (frequency-relabeled ids, whose dense head stages), unsorted Zipfian ids
   with -1 pads and out-of-range ids, unsorted ids with duplicates, a
   bfloat16 table, a table whose last window is partial, and a table
   smaller than the window (which goes through the gather kernel). Each
   case runs under three staging rules (none, dense runs, every run), all
   bit-equal, with what each stages (`staged_bytes`) and its time; after
   the apply phase, torch.profiler must see one device kernel per call
   (traced after the three kernel phases' timings, and before the later
   phases' many profiler sessions, after which a session has once traced
   no kernel at all; every profiler check counts only a session that
   traced both spin kernels around the call, `device_kernels`). Times: the
   kernel, its plain version, the gather kernel and the library call,
   beside the byte bound;
5. apply   — the fused sparse apply against its plain version on the card.
   Main case: the 2^24 x 10 float32 table and its Adagrad accumulator,
   updated from one `synthetic_criteo(4096, id_space=2^24, seed=7)` batch
   deduplicated by `ops/sparse._dedup_routed`; every table and slot must be
   bit-equal after the same in-place update of two clones, and an update
   whose counts are all 0 must leave both bit-identical. Times: the kernel,
   its one-slot call (the floor of a launch) and its all-padding call (one
   coalesced count and id round per tile), the kernel and its one-slot
   call again with L2 emptied before each call (rows from DRAM, not from
   the L2 the timed calls leave them in), the plain version,
   `torch.optim.Adagrad` stepping on the same coalesced sparse gradient (a
   yardstick the port never calls), the bound from the bytes the update must move (and from
   the 32-byte sectors it touches). Packed cases: the gate
   (`ops/sparse.packed_layout`) refuses the table on the card; the same
   update through the packed weights+slots array (2^24 x 20 at width 10,
   2^22 x 128 at width 64) is bit-equal to the split arrays all the same,
   with the gather and the apply timed in both layouts and the pack and
   unpack that a packed window adds: the measurement behind the gate's
   refusal.
   Edge cases of the kernel's lane map, two updates each, bit-equal, with
   the launch plan checked against
   the kernel's: widths 1, 9, 10, 11, 16, 64 and 128 (words of 1, 2 and 4
   elements, partial tiles; int32 ids at two of them), bfloat16 tables of
   widths 10 and 16, RMSprop's slots as column views 4 and 8 bytes off a
   16-byte boundary (the columns between them untouched), a `w[1:]` view,
   n = 1 and n = 1001 slots, an update whose counts are all 0 (tables
   bit-identical), and Adam, Adamax and TestOptimizer (per-row state) at
   widths 10 and 64. Further cases: all nine optimizer rules on a small
   table with duplicates, -1 pads and out-of-range ids, a bfloat16 table
   with Adam (the 1-wide per-row slots), each bit-equal; Ftrl with
   learning_rate_power -0.7 (`powf`) within a stated tolerance. Then
   torch.profiler must see one device kernel per apply call;
6. serve   — the full-width DeepFM (`make_deepfm(vocabulary=1<<24, dim=9)`,
   random weights from a seed) exported, loaded by a REST server and driven
   through `ServingClient`: predict at batch 1, 100 and 4096 and a pull. The
   answers must equal the same servable's in-process forward with the plain
   gather in place of the kernel (tolerance 0: the gather is a copy and
   everything else is the same code on the same card), and the kernel's
   launch count must rise by one per table per predict and one per pull;
7. train   — the same DeepFM trained by `Trainer` with Adagrad(0.05) from a
   seeded init on `synthetic_criteo` batches of 4096: 24 eager
   `train_step`s and two eager `train_many` windows of 16 (split: the gate
   packs no table on the card); each step must launch exactly one gather
   and one apply per table. The
   same 56 steps from a clone of the initial state as eager `train_step`s
   with the plain versions swapped in must launch no kernel and give the
   same losses, tables, accumulators, dense parameters and dense slots, bit
   for bit (the gather is a copy, the apply is bit-equal, the segment sums
   keep one order, and cuBLAS runs with a fixed workspace). Then the same
   steps from another clone through the CUDA graphs: 24 `jit_train_step`
   calls and two `jit_train_many` windows of 16, bit-equal again; each
   captured step launches one gather and one apply per table, and the
   launches that ran (warm-ups and replays; a capture runs nothing) are
   one gather and one apply per table per step. Last, the two windows again,
   from the state after the 24 graph steps, through a `jit_train_many`
   whose gate packs the table: the packed layout the card's gate refuses,
   held bit-equal to the split steps and timed against them. Prints ex/s
   for each way of stepping, the profiler's device busy time, idle share
   and top device operations per step, and the peak device memory;
8. example — the Criteo training entry point (`python -m
   openembedding_tpu_torch.examples.criteo_deepctr`, through its `main`)
   on a Criteo-format TSV written from a seed (20 x 4096 rows, about 20 MB:
   a label, 13 integer counts and 26 8-hex-digit Zipfian tokens, about 5%
   of the fields empty) and its .gz copy. The native reader's batches
   (plain and .gz) must be byte-identical to the Python reader's; both
   engines' rows/s, and the native reader's steady ms per batch as the
   entry point's loop reads it. The full-width DeepFM at `--vocabulary 16777216 --dim 9
   --batch-size 4096`, 64 steps (the file repeats), through eager steps,
   `jit_train_step` and `jit_train_many` (`--scan 16`), each with and
   without `--prefetch` (pinned, double-buffered, side stream): every run
   bit-equal (losses and whole state) to the same steps through both plain
   versions with no prefetch, and launching one gather and one apply a
   step; ex/s and the idle share of each (its driver's device busy time
   under the profiler against the run's steady wall time). Save after one
   pass of the file, load into a fresh state, continue: bit-equal to the
   uninterrupted plain run; the export's logits equal `eval_step`'s.
   The copy alone: `jit_train_step` over the file's batches already
   parsed, each batch copied pageable, by the pinned prefetch as the steps
   run, or pinned before the loop, in turns.
   `--cache` with a 2^20 x 10 sparse_as_dense table: eager and graph
   drivers bit-equal to the plain path, the profiler sees the gather kernel
   on the table's pull, and the checkpoint and export round-trip it;
9. hash    — the hashed flagship, `make_deepfm(1 << 24, 9, hashed=True,
   capacity=1 << 24)` (2^24 int64 keys, a 2^24 x 10 float32 table and its
   Adagrad accumulator), on the example phase's TSV (written again from
   its seed) read into the 2^62 id space: 64 eager steps, 64
   `jit_train_step` calls and four `jit_train_many` windows of 16, each
   bit-equal in losses and whole state (keys, weights, slots, overflow,
   dense) to the same steps through the plain versions, one gather and one
   apply a step; save after 20 steps, load into a fresh state and run the
   other 44: the losses and the id -> row contents of the uninterrupted
   run; the export's logits equal `eval_step`'s; a table of a quarter of
   one batch's unique ids, 8 eager and 8 graph steps bit-equal to the
   plain path with the same nonzero overflow; the same table filled to
   0.6 of its slots with seeded ids before one pass of the file (3 eager
   steps, then graph steps), bit-equal to the plain path. Reports, at
   both loads, the probe's device time and launches a step (the kernels
   inside its profiler range in eager steps; the push takes the pull's
   slots, so a step probes once), each probe alone by CUDA events, the
   graph step's ms, device ms and idle share (beside the array flagship's
   graph run of the example phase), the load and the new ids of every
   step, and the peak device memory;
10. lr_example — `python -m
   openembedding_tpu_torch.examples.criteo_lr_subclass` through its `main`
   at its own settings (a hashed LR of 2^16 slots on
   `examples/train100.tsv`, batch 32, 4 epochs) with `--checkpoint` and
   `--save`, bit-equal to its steps through the plain versions (eager:
   the plain apply cannot be captured), then `--load` of the checkpoint
   for one more epoch;
11. zoo    — the entry point's `main` for `--model` lr, wdl, xdeepfm, dcn
   and dlrm at `--vocabulary 16777216 --dim 9 --batch-size 4096` on the
   TSV: 16 eager and 16 graph steps, each bit-equal to the plain path, one
   gather a step (and one at init) and one apply a step; the graph run's
   export served over REST, its logits equal to `eval_step`'s; ms, device
   ms and idle share a step per family;
12. mesh   — the mesh path (`openembedding_tpu_torch.parallel`), each
   run bit-equal to the same run through the plain versions. mesh1:
   `make_deepfm(1 << 24, 9)` through `MeshTrainer` on a one-rank NCCL
   group (`case_mesh1` of `bench.py`), the train phase's batches: 24
   eager steps and two windows of 16, then the same through
   `jit_train_step` and `jit_train_many` (no collective at S = 1), one
   gather and one apply a step; the single-device Trainer from the same
   state (its largest difference reported), ms a step, device ms and idle
   share beside the array flagship's graph step. mesh4-staged: four gloo
   ranks spawned on the one card (`multihost.run_local`; the kernels were
   built before they start), the same table at 2^22 rows a shard, global
   batch 4096 (1,024 a rank): four eager steps at the fp32 wire and four
   at the default bf16 wire (a float32 tower), and two steps of the
   hashed flagship (2^22 slots a shard); each rank holds its steps bit-equal to the plain
   versions (keys and overflow too) and launches both kernels; step 0's
   rows (fp32 wire) within rtol 1e-5 / atol 1e-6 of the single-device
   Trainer with its loss scaled by 4, from the same shards interleaved;
   ms a step and the bytes staged through the host. mesh4-placement: the
   same four ranks, table and batch, 4 eager steps of each placement
   configuration (`PLACE_CONFIGS`): (a) the int8 wire with error
   feedback, (b) 1,024 hot rows (the run's most frequent ids) at fp32,
   (c) 256 migration rows at fp32, the moves from `plan_migration` over
   step 0's `shard_positions`, (d) all three with the int8 hot reduce;
   each bit-equal to the same steps through the plain versions, (b) and
   (c) after `hot_sync` bit-equal to the run without placement and their
   sharded saves byte-identical to its save; every rank launches both
   kernels, and a step the gathers and applies of its paths (the owner's,
   the residuals' read, the cache's, the annex's); ms a step, staged
   bytes against `wire.exchange_cost`, hot hit ratio, `hot_unique`,
   `hot_bytes_saved`, shard imbalance before and after the moves, peak
   memory. mesh4-pipelined: the same four ranks, table and batch, each
   configuration of `PIPE_CONFIGS` ((a) fp32, (b) int8 with error
   feedback, (c) int8 with 1,024 hot rows, 256 migration rows and the
   int8 hot reduce) from one state through a serial `train_many` window
   of 4 and a pipelined one (`pipeline_steps=True`), bit-equal, the
   pipelined one bit-equal again through the plain versions and with its
   prefetch on the side stream; the conflict patch repairs rows, none
   past its cap; the pipelined window launches the serial one's kernels
   and one readonly gather a body step (two with the annex), and stages
   the serial one's bytes and the patches' (`wire.conflict_patch_cost`)
   exactly; ms a step of both. mesh4-zero: the same four ranks, table and
   batch on `case_zero`'s Adam(0.001), 4 eager steps of each
   configuration of `ZERO_CONFIGS` ((r) replicated, (a) `dense_shard`
   fp32, (b) bf16, (c) int8, (d) sparse_topk dense wire), each bit-equal
   to the same steps through the plain versions; (a) bit-equal to (r)
   (losses and the externalized state) and their sharded saves
   byte-identical; `set_dense_wire` from (a) to int8 and back, the
   externalized state unchanged; (c) and (d) saved, loaded into a trainer
   without ZeRO (equal, one step) and into their own (the residual zero);
   the pipelined window of 4 with (a) bit-equal to the serial one; every
   rank launches both kernels; staged bytes a step are (r)'s less its
   dense sum plus `zero.dense_wire_cost`'s collectives, exactly, and a
   rank's dense optimizer state `zero.plan_device_bytes` (about 1/4 of
   (r)'s); ms a step. The entry point's `--mesh` at one rank on
   the TSV: a graph run saved (sharded) after one pass, loaded, 16 steps
   more, held to one uninterrupted plain run. NCCL across cards
   (`jit_train_step` captured; (d) across a `refresh_hot_rows` and a
   `migrate_rows`, one capture, bit-equal to eager; the fp32 windows,
   serial and pipelined, eager and through `jit_train_many`, one capture
   each, bit-equal, ms a step of each graph; ZeRO (a) through
   `jit_train_step`, one capture, bit-equal, then `set_dense_wire` to
   int8, one capture more; (c) and (d) through `jit_train_many`,
   bit-equal) only
   where the machine has
   two cards or more; otherwise the phase says it did not run;
13. persist — persistence (`openembedding_tpu_torch/persist.py`), each
   run bit-equal after its restore. (s) the array flagship through
   `jit_train_step`, 12 steps with an `IncrementalPersister` (a persist
   every 2 steps, a full base every third, window 2, keep 2): restored into
   a fresh state whose graph driver was captured before the restore, the
   whole state (tables, slots, dense, step) and the step after equal the
   live run's; the touched-row read through the gather kernel equals its
   plain version; the bytes of each full persist and delta, the touched
   rows a delta, the ms of each snapshot (`persist()` returning) and write,
   the restore's, and the step's ms with the persister on and off over the
   same batches. (h) the hashed flagship on the TSV, 6 graph steps, a
   persist every 2: restored equal by id -> rows. (m) four gloo ranks on
   the card (2^22 rows a shard, global batch 4096), the int8 wire with
   residuals, 1,024 hot rows and 256 annex rows, and ZeRO on Adam, 4 eager
   steps each with a persist every 2: one delta file and one done marker
   a rank, rank 0 alone commits; the root restored at S = 4 equals the
   live state on every rank, and the step after; restored on one device,
   each rank's rows and the dense part equal the live state's. (e) the
   entry point's `--persist ROOT --persist-steps 5 --persist-incremental`
   over the TSV: restored equal to `main`'s state. NCCL across cards only
   where there are two cards or more. Gather and apply launches counted
   on the path;
14. offload — host-cached tables (`tables/host_offload.py`) at full width:
   (o1) the hashed flagship, its table host-cached in a 2^17-slot cache
   (78,643 ids under the 0.6 mark; one pass of the TSV holds about 411
   thousand distinct ids), 40 `jit_train_step` calls (two passes) with
   `offload_prepare` before each: one capture across every eviction, at
   least three evictions, rows re-admitted from the store, a store larger
   than the cache; bit-equal (losses, cache and store by id, dense state)
   to the same steps through the plain versions; launches exactly one
   gather and one apply a step, four gathers an eviction, two a resident
   read. (o2) a Constant(0.0) cache against the in-HBM hashed flagship of
   2^24 slots over the same batches: losses and rows by id bit-equal.
   (o3) `offload_pipeline=True`, `offload_stage_depth=2`,
   `offload_densify=4`, staging one batch ahead and, in a second run, two:
   each bit-equal to (o1), with its hits and misses per ring slot. (o4) the entry point's `--offload` over the
   TSV, stepwise with `--persist` and with `--scan 4` (a 2^18-slot cache,
   which holds a window's union), each with `--save` and `--export`: the
   export's logits equal `eval_step`'s, the checkpoint loads into the
   in-HBM flagship equal by id, the persist root restores bit-equal.
   (o5) mesh4-offload: four staged gloo ranks on the card, a cache of 4 x
   2^15 slots, 6 eager steps: bit-equal by id to the plain versions and
   to the in-HBM mesh at Constant(0.0); one full persist restored
   bit-equal. (o6) `jit_eval_step` on the array flagship: five calls, one
   capture, logits and loss bit-equal to the eager `eval_step`. Reports
   the median ms of `prepare` and its parts (split, store lookup, upload,
   admission), of an eviction and a flush, the graph step with the cache
   against the in-HBM table's, the store's rows and bytes, the launches,
   and the card's name and power limit;
15. seq    — the retrieval and sequence families at published widths.
   (q1) SASRec at Kang & McAuley's MovieLens-1M widths
   (`make_sasrec(3416, 50, num_heads=1, num_blocks=2, max_len=200)`,
   Adam(0.001), batch 128, bfloat16, `synthetic_sequences`): 16 eager
   steps, 16 `jit_train_step` calls and two `jit_train_many` windows of 8,
   each bit-equal (losses and whole state) to the same steps through the
   plain versions, one gather and one apply a step; `jit_eval_step`
   bit-equal to `eval_step`; the export served over REST, its (128, 200,
   2) logits equal to `eval_step`'s. (q2) BERT4Rec at Sun et al.'s ML-20m
   widths (`make_bert4rec(26744, 64, num_heads=2, num_blocks=2,
   max_len=200)`, Adam(1e-4), batch 256, mask rate 0.2): 8 eager and 8
   graph steps, each bit-equal to the plain versions; the [MASK] row
   (id 26,744) trains. (q3) `SeqMeshTrainer` on four staged gloo ranks
   as a (2, 2) (data, seq) mesh, q2's model at float32 with Adagrad(0.1):
   ring and Ulysses attention, 4 eager steps each (ring also through the
   plain versions, bit-equal), the first batch's logits and the four
   losses within `SEQ_MESH_TOL` of the single-device full-attention
   Trainer from the same state; staged bytes a step; over NCCL through
   `jit_train_step` where there are four cards. (q4) the two-tower: the
   ported example's `main` at its defaults; `make_two_tower(138493,
   26744)` (dim 16, tower 256-128, combiner mean) with Adagrad(0.1) at
   batch 4096, 8 eager and 8 graph steps bit-equal to the plain versions,
   the export served over REST at widths 3/2, equal to the in-process
   predict. (q5) `EmbeddingVariable` on a 2^24 x 10 table: sparse_read,
   push_gradients and update_weights of 106,496 Zipfian ids, bit-equal to
   the plain versions. Step times, device busy time and idle share;
16. obs     — observability on the main path, on the array flagship
   (`make_deepfm(1<<24, 9)`, Adagrad(0.05), `synthetic_criteo(4096,
   id_space=2^24, seed=7)`). (o1) 40 `jit_train_step` calls from one
   state with the sentinel off, on with `record_step_stats` every step,
   and on through the plain versions (eager): losses and the whole state
   bit-equal, the health gauges of the kernel run equal to the plain
   run's, the same kernel launches a step on and off, `health.grad_norm`
   within 1e-5 of a float64 sum of one step's gradients; wall ms a step
   off, on with the read, on without, the read alone, device ms off and
   on. (o2) `halt_on_nonfinite=True`: a NaN planted after step 4 in a row
   step 5 pulls, in the first dense weight, or in one label raises
   `NonFiniteError` at step 5 naming the table, `dense` and `loss`; a
   capsule written and loaded; the flight recorder's `health/nonfinite`;
   with the halt off the same runs record and do not raise. (o3)
   `measure_every=8` over 40 graph steps: 5 `trainer.step_ms` samples.
   (o4) the entry point on the TSV with `--report-interval 1
   --metrics-log --flight-recorder 4096 --trace-dump --skew-report
   --profile`, and with `--skew-report` alone, against the plain run:
   losses bit-equal, the JSONL, the Chrome trace (its `trainer` spans) and
   the profiler's trace parse, each listed hot id within `est - err <=
   true <= est` of the kept batches' exact counts; steady ex/s each way
   and the sketch's drops. (o5) four staged gloo ranks, int8 wire with
   error feedback and `halt_on_nonfinite`: equal health on every rank, a
   NaN label in rank 0's rows raises on every rank at step 3; staged
   bytes a step with the sentinel on and off against `exchange_cost`.
   (o6) the flagship exported and served: 32 REST predicts of 4096 rows
   with request ids, `/metrics` counting them, `/tracez` holding their
   `serving/predict` spans, `/statusz`, `/sloz`, `/historz`,
   `/timelinez`, `/fleetz` over two servers, the sketch's ids; REST p50
   with and without a `/metrics` scrape between predicts;
17. placement — self-driving placement (`placement/controller.py`,
   `utils/memwatch.py`): `bench.py`'s placement case on four staged gloo
   ranks on the one card, the flagship at full width (2^22 x 10 rows and
   the Adagrad accumulator a rank), batches of 4096 x 26 of a drifting
   Zipf stream (a heavy pool of 64 ids drawn with weights 1/(r+1) at 0.6
   of the positions, homed on shard 3 for 30 steps, on shard 1 for 30
   more; the tail uniform over 2^24). `PlacementPolicy(32 rows' bytes,
   mig_rows=64, refresh_cooldown_steps=3, imbalance_target=1.05)`, a
   `SkewMonitor(k=256, decay=0.9)` fed the global ids, a decision every
   3 steps. A prime under a 1-byte budget keeps the sizes and records
   `placement/prime_rejected`; `publish_memory` after init and after
   prime, `analytic == measured` on every component, with
   `memory.hbm_used`, the card's memory and `memory.model_drift`. The
   controller-on run through the kernels and through the plain versions
   from the same state: losses and the whole state bit-equal, every rank
   the same losses, hot sets, moves and `status()`. The controller-off
   run on the same batches: its post-drift imbalance above the on run's.
   Imbalance before and after the drift, hit ratio, refreshes and
   migrations, ms a step on and off, the sketch feed's and `on_step`'s ms,
   the launches of each kernel;
18. sync    — online model sync and live replicas (`sync/`, `serving.py`),
   `bench.py`'s `case_sync` at the flagship's full width: the array
   flagship trained with Adagrad(0.05) through `jit_train_step` on
   `synthetic_criteo(4096, id_space=2^24, seed=24)`,
   `IncrementalPersister(window=2, every_steps=1, full_every=100)`
   writing a base and 6 deltas; a publisher node (`make_server(publish=)`)
   and a serving node (`batch_window_ms=2.0, max_batch=4096`) loaded with
   the base's export, in the process, on the card. A subscriber polls
   after each delta: each swap's servable gives logits on the first
   training batch bit-equal to a fresh export of the trainer's state and
   to its plain-version forward, and moved from the last; four client
   threads post 1024-row REST predicts through the `MicroBatcher` across
   every swap with no failure, in fewer device batches than requests. A
   truncated payload (`FaultInjector`) degrades with a rollback and the
   same servable, and the next poll recovers. Fresh managers follow the
   whole chain in one poll at fp32, bf16 and int8: rows within 0, 3e-2
   and 6e-2 of the largest magnitude of the trainer's, and
   `sync.wire_bytes_per_delta` equal to `sync_delta_cost`. A third node
   restores from the serving node (`restore_from_peer`, pages of 2^20
   rows), bit-equal logits. Times: ms a delta by hop (fetch, apply,
   swap) and a poll, the apply's device ms (clone and row copy) against
   its byte bound, ms and rows/s and bytes a delta per wire format, REST
   p50 at 4096 rows with the batcher (subscriber polling and idle) and
   without, the restore's seconds and MB/s, the card's memory before and
   after the swaps, the launches (the checks' own taken out);
19. shard   — sharded serving (`parallel/serving.py`, `ShardedModel`) at
   the flagship's full width: the array flagship trained one
   `jit_train_step` on `synthetic_criteo(4096, id_space=2^24, seed=36)`
   with an `IncrementalPersister` (a base, then a delta a step), written in
   the single layout (`Trainer.save`) and, by four staged gloo ranks
   loading it, in the sharded layout. (a) Each layout served at T = 4 and
   T = 2 shards staged on the one card: every shard holds
   `rows_per_shard(T)` rows; one batch's ids with -1 pads and out-of-range
   ids pull the trainer's rows bit for bit; predict at 4096 rows launches
   one gather a shard and is bit-equal to `StandaloneModel.predict` of an
   export of the same state and to the same servable through the plain
   gather. (b) The hashed flagship (2^24 slots) after one graph step,
   served at T = 4: bit-equal to the trainer's read-only pull, absent ids
   zero; each shard's slots beside JAX's size. (c) REST:
   `make_server(devices=["cuda:0"] * 4)`, `POST /models` with
   `shard_num=4` ends NORMAL, pull and predict answer the trainer's rows
   and the standalone logits, `shard_num=8` is refused (500, ERROR), and
   `restore_from_peer` from the sharded node gives an export with
   bit-equal logits. (d) A subscriber follows 3 deltas into the sharded
   servable (a standalone twin follows the same feed): after each swap the
   touched rows equal the trainer's by id, the servable before it is
   unchanged, and four client threads post REST predicts across the swaps
   with no failure. (e) A DeepFM whose table is bfloat16, exported and
   checkpointed, served standalone and at T = 4: rows bit-equal to the
   trainer's bfloat16 rows, logits equal. Times: load seconds at each T,
   in-process and REST predict p50 at 4096 rows sharded and standalone,
   the `apply` hop a delta sharded and standalone, the restore's MB/s,
   each shard's bytes, gather launches a predict, the card's name and
   power limit;
20. ingest  — the ingest path (`data/ingest.py`,
   `MeshTrainer.train_stream`) and remote storage (`utils/fs.py`) at the
   flagship's full width (`make_deepfm(1 << 24, 9)`, Adagrad(0.05), batch
   4096, windows of K = 8), on a one-rank NCCL mesh (`make_mesh()` on
   cuda:0), `tools/ingest_soak.py`'s phases: (1) the ceiling, pre-staged
   windows through the window driver (`jit_train_many`, wrapped in
   `utils/guards.assert_no_recompile`), min ms a step; (2) the replay line
   rate, batches of two `synthetic://` files parsed before the timer and
   served by a source registered with `ingest.register_source`, the ring
   (depth 3) stacking and staging them into `train_stream`: ex/s and the
   input-wait share; (3) the synthetic line rate, `ingest.feed(...,
   source="synthetic", workers=2, depth=3, window=8)`; (4) the throttled
   control, the producer paced at 2x the ceiling a batch at depth 1, over
   the synthetic source (the soak's recipe; its share must read over 0.5)
   and over the replay source (reported); one capture across every
   stream, K gathers and K applies a window; (5) the replay stream's state
   and losses bit-equal to the same windows through `train_many` with the
   plain versions, eager, from the same initial state; (6) four staged
   gloo ranks on the card fed by `ingest.feed(..., mesh=mesh, window=4)`
   over 2 windows, each window's collective fingerprint equal on every
   rank and across the windows, losses and state bit-equal to the same
   global windows built by hand through `train_many`; (7) a `ShellPipeFS`
   over cat / cp / test / ls / mkdir registered as `oefs://`: the replay
   state saved to a URI and loaded back bit-equal, an export staged out
   and loaded from the URI predicting 4096 rows bit-equal to the local
   export, `read_criteo_tsv` over a URI equal to the local read, and the
   MB/s of `stage_out` / `stage_in` and of the checkpoint's save and load;
21. soak    — the online-sync soak (`openembedding_tpu_torch.sync_soak.run`,
   the port of `tools/sync_soak.py`) at the flagship's width: the array
   DeepFM (`make_deepfm(1 << 24, 9)`, its 400-400-400 tower), batch 4096
   of `synthetic_criteo` ids over 2^24, the fp32 wire, 4 predict threads
   posting the first batch over REST across every swap, 13 steps through
   `jit_train_step` (a base at step 1, a delta every 2 steps). (a) A plain
   run, the trainer unpaced; (b) a quiet run, the same without predict
   threads; (c) a paced run of 7 steps, the trainer sleeping 1.5x the plain
   run's slowest delta service (the subscriber's fetch, apply and swap)
   after each step: the version lag never above 2 deltas' steps
   (`lag_bound_steps=4`), and birth to swap growing over the run by no
   more than one delta's service; (d) a stall run with `timeline=True`:
   the publisher withholds delta payloads, the freshness threshold 3x the
   slowest delta latency (birth to swap) the plain run measured and the
   stall twice the threshold. Each run: no failed predict, lag 0 at the
   end, a swap for every delta, one capture, the swapped servable's logits
   bit-equal to a fresh export of the last step's, the gather and the
   apply launched (replays counted); the collective fingerprints of all
   runs equal; in the stall run `serving_freshness` breaches and recovers,
   the `fetch` hop dominates `sync.hop_ms`, and the last delta's chain
   merged from both nodes' `/timelinez` is complete and ordered. Each
   delta's birth-to-swap ms, the trainer's commit gap, the subscriber
   thread's wall and CPU ms in its fetch and in its apply and swap; how
   late a thread's 1 ms sleeps wake (the interpreter lock's waits) and
   the process's CPUs in use; hop ms, swaps, wall seconds;
22. demo    — the serving demo (`examples/serving_demo.main`) at the
   flagship's widths (2^24 x 10 table, 400-400-400, batch 4096): the REST
   pull answers the trained table's rows and the REST predict the
   in-process `StandaloneModel.predict`, each bit for bit; the gather and
   the apply launched;
23. keras   — the Keras bridge: where Keras is installed, a plain-Keras
   DeepFM of the flagship's widths (an `Embedding(1 << 24, 9)` fed by a
   39-field id input, the FM term, the 400-400-400 tower) converted by
   `keras_compat.from_keras_model` and trained 8 steps through
   `jit_train_step` and through eager `train_step`s from clones of one
   state, bit-equal, with both kernels counted; a failed capture fails the
   phase. Where Keras is not installed (the card's machine has none) it
   prints `{"phase": "keras", "ran": false, "why": "keras not installed"}`
   and counts nothing: not a pass;
24. microbench — `openembedding_tpu_torch.microbench` at full size (its own
   JSON lines): every kernel at widths 64 and 128 against its plain version
   and a library call, and the train step through the graph, eager and
   plain. Its launches are counted as they ran: its graph's capture is
   taken out and its replays put in.

Then the `kernels` line, and last `{"ok": true, "device": {...}}`.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

# cuBLAS picks its workspace per stream unless told otherwise, and results
# may then differ between runs; set before CUDA initializes
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

SEED = 0
VOCAB = 1 << 24          # the flagship table: 2^24 rows
DIM = 9                  # latent width; the folded table is DIM + 1 wide
BATCH = 4096
FIELDS = 26              # Criteo categorical fields
NUM_DENSE = 13           # Criteo dense fields
SIGN = "deepfm-smoke-0"
TRAIN_SEED = 7           # synthetic_criteo seed of bench.py's trainer case
TRAIN_STEPS = 24         # train_step calls; the first WARM_STEPS are untimed
WARM_STEPS = 4
MANY_STEPS = 16          # K of each train_many window
MANY_WINDOWS = 2         # the graph is captured on the first, replayed after
KERNELS = ("gather_rows", "gather_rows_windows", "fused_sparse_apply")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def zipf_ids(rng, n: int, vocab: int) -> np.ndarray:
    """Zipf(1.1) ranks scattered over the table, with 2% -1 pads and 1%
    out-of-range ids (all below 2^31, so the int32 cases see them too)."""
    ranks = rng.zipf(1.1, n) - 1
    ids = (ranks % vocab) * 2654435761 % vocab
    u = rng.random(n)
    ids[u < 0.02] = -1
    oor = (u >= 0.02) & (u < 0.03)
    ids[oor] = vocab + rng.integers(0, 1 << 20, int(oor.sum()))
    ids[:8] = [-1, vocab, vocab - 1, 0, (1 << 31) - 1, -(1 << 31), 5, vocab]
    return ids.astype(np.int64)


def make_batch(rng, n: int) -> dict:
    return {"sparse": {"categorical":
                       zipf_ids(rng, n * FIELDS, VOCAB).reshape(n, FIELDS)},
            "dense": rng.standard_normal((n, NUM_DENSE)).astype(np.float32)}


def host_ms(torch, fn, iters: int = 200) -> float:
    """Wall time per call of back-to-back calls ending in a synchronize:
    what a caller pays per call, host overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _gather_case(torch, mb, gather, tname, w, ids_host, id_dtype, valid_np,
                 dev) -> dict:
    """One gather case: the kernel bit-equal to its plain version, its
    time beside the plain version's, the library call's and the bound."""
    ids = torch.from_numpy(ids_host).to(dev, id_dtype)
    valid = (torch.from_numpy(valid_np).to(dev) if valid_np is not None
             else None)
    launches = gather.LAUNCHES["gather_rows"]
    got = gather.gather_rows(w, ids, valid)
    check(gather.LAUNCHES["gather_rows"] == launches + 1,
          "one gather_rows call is one kernel launch")
    want = gather.gather_rows_reference(w, ids, valid)
    torch.cuda.synchronize()
    equal = torch.equal(mb.bits(got), mb.bits(want))
    err = float((got.float() - want.float()).abs().max())
    n_rows = w.shape[0]
    nbytes = mb.gather_bytes(ids_host, ids.element_size(), valid_np, n_rows,
                             w.shape[1], w.element_size())
    rec = {
        "phase": "kernel", "case": tname,
        "table": f"{str(w.dtype).split('.')[-1]} {n_rows}x{w.shape[1]}",
        "table_address_mod_16": w.data_ptr() % 16,
        "ids": f"{ids.shape[0]} {str(id_dtype).split('.')[-1]}",
        "mask": valid is not None, "bit_equal": equal, "max_abs_err": err,
        "ms": mb.device_ms(lambda: gather.gather_rows(w, ids, valid)),
        "plain_ms": mb.device_ms(
            lambda: gather.gather_rows_reference(w, ids, valid)),
        "library_ms": mb.device_ms(lambda: mb.library_gather(w, ids, valid)),
        "host_ms_per_call": host_ms(
            torch, lambda: gather.gather_rows(w, ids, valid)),
        **nbytes,
        "bound_ms": nbytes["useful_bytes"] / mb.HBM_BYTES_PER_S * 1e3,
        "sector_bound_ms": (nbytes["sector_read_bytes"]
                            + nbytes["useful_bytes"]
                            - nbytes["read_bytes"]) / mb.HBM_BYTES_PER_S
        * 1e3,
    }
    emit(rec)
    check(equal, f"gather_rows bit-equal to its plain version ({rec})")
    return rec


def phase_kernel(torch, mb, gather) -> dict:
    """Kernel vs plain version at the serving path's shapes and at the
    edges of the row-copy core (word widths, alignment, ragged tiles, the
    one-row launch floor); returns the main-path case (float32 table, int64
    ids, no mask) for the kernels line."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    w32 = torch.randn((VOCAB, DIM + 1), generator=gen, device=dev)
    ids_np = zipf_ids(rng, BATCH * FIELDS, VOCAB)
    ids64_np = ids_np.copy()
    ids64_np[8:24] = (1 << 40) + np.arange(16)  # past int32, int64 only
    mask_np = rng.random(ids_np.shape[0]) < 0.9
    cases = [("main", w32, ids64_np, torch.int64, None),
             ("int32 ids", w32, ids_np, torch.int32, None),
             ("int32 ids, mask", w32, ids_np, torch.int32, mask_np),
             ("mask", w32, ids64_np, torch.int64, mask_np)]
    # uniform ids: no hot rows for L2 to keep, unlike the Zipfian cases
    uniform_np = rng.integers(0, VOCAB, ids_np.shape[0])
    cases.append(("uniform ids", w32, uniform_np, torch.int64, None))
    w16 = torch.randn((VOCAB, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    cases.append(("bf16 width 64: 16-byte words", w16, ids64_np, torch.int64,
                  None))
    # the core's other words: 36-byte rows move in 4-byte words, 18-byte
    # bfloat16 rows in 2-byte words, and a view that starts 40 bytes into
    # the table (8-byte aligned) in 8-byte words
    w9 = torch.randn((1 << 22, 9), generator=gen, device=dev)
    ids22_np = zipf_ids(rng, BATCH * FIELDS, 1 << 22)
    # LR's table: rows one float wide (4 bytes), the hashed pull's miss row
    # (slot == capacity) and -1 pads among the ids
    w1 = torch.randn((VOCAB, 1), generator=gen, device=dev)
    ids1_np = ids64_np.copy()
    ids1_np[100:140] = VOCAB
    cases += [("f32 width 1: LR's 4-byte rows", w1, ids1_np, torch.int64,
               None),
              ("f32 width 9: 4-byte words", w9, ids22_np, torch.int64, None),
              ("bf16 width 9: 2-byte words", w9.to(torch.bfloat16), ids22_np,
               torch.int64, None),
              ("view w[1:], 8-byte aligned", w32[1:], ids64_np, torch.int64,
               None),
              # n not a multiple of the 32-row tile, and one row: the
              # floor of one launch
              ("n = 1001", w32, ids64_np[:1001], torch.int64, None),
              ("n = 1: launch floor", w32, ids64_np[6:7], torch.int64, None)]
    main = None
    for tname, w, ids_host, id_dtype, valid_np in cases:
        rec = _gather_case(torch, mb, gather, tname, w, ids_host, id_dtype,
                           valid_np, dev)
        if tname == "main":
            main = rec
    return main


BRACKET_CYCLES = 1_000_000  # the spins around the call: about 0.5 ms
WARM_CYCLES = 10_000        # the spins that open a session: about 5 us


def profiled_session(torch, fn, opening: int = 32) -> list:
    """One torch.profiler session of one call of `fn` between two spin
    kernels of `BRACKET_CYCLES`; the session ends 10 ms after the last
    kernel. It opens with `opening` short spins, run to their end: on the
    H100 a session may lose its first device records (late in the script,
    an eager step's session lost its first three every time), and they
    absorb the loss. -> [(name, us on the device)] of the device records
    traced, in order of start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.01)
        for _ in range(opening):
            torch.cuda._sleep(WARM_CYCLES)
        torch.cuda.synchronize()
        torch.cuda._sleep(BRACKET_CYCLES)
        fn()
        torch.cuda._sleep(BRACKET_CYCLES)
        torch.cuda.synchronize()
        time.sleep(0.01)
    device = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in device]


def bracket_spins(traced) -> int:
    """The spins of `BRACKET_CYCLES` among a session's records (a short
    opening spin runs about 5 us, a bracket about 500)."""
    return sum(1 for name, us in traced if "spin" in name and us >= 100)


def device_kernels(torch, fn, tries: int = 5) -> tuple:
    """Names of the device kernels that one call of `fn` enqueues, as
    torch.profiler traces them, and what each profiler session it took
    traced (bracket spins, opening spins, other records). Each
    session is a `profiled_session`: the call sits between two spin
    kernels (left out of the names). The trace of a session may lose
    device records on the H100: a short session of one call alone has
    traced no kernel at all, and a session of a whole training step has
    lost its first records (hence the opening spins). So a session counts
    only when it traced both brackets, the spin before the call and the
    one after; one that lost either is taken again, up to `tries` sessions
    (the card ran the call: its output is checked). If no session traced
    both, the names of the last are returned and the caller's check fails
    on them."""
    sessions = []
    for _ in range(tries):
        traced = profiled_session(torch, fn)
        names = [name for name, _ in traced if "spin" not in name]
        spins = bracket_spins(traced)
        sessions.append({"spins": spins, "records": len(names),
                         "opening": len(traced) - len(names) - spins})
        if spins == 2 and names:
            break
    return names, sessions


STAGE_SHARES = (float("inf"), 0.5, 0.0)  # none, dense runs, every run


def phase_windows(torch, mb, gather, gather_windows, sparse, data) -> dict:
    """The window gather against its plain version and the gather kernel,
    under three staging rules; returns the main case (the dedup's sorted
    ids, window 16, the default rule) and the calls `kernels_profile`
    traces once every timing is done."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    w32 = torch.randn((VOCAB, DIM + 1), generator=gen, device=dev)
    batch = next(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                       seed=TRAIN_SEED))
    ids = torch.from_numpy(batch["sparse"]["categorical"].reshape(-1)).to(dev)

    def dedup(ids):
        # the ids the apply reads as the dedup emits them: the sorted
        # unique ids, then one distinct out-of-range id per padding slot
        return sparse._dedup_routed(
            VOCAB, ids, torch.zeros((ids.shape[0], 1), device=dev), None)[2]

    # Zipf(1.1) ranks left unhashed: frequency-relabeled ids, as the
    # reference's criteo_preprocess.cpp writes them; their head is dense
    ranks = rng.zipf(1.1, BATCH * FIELDS) - 1
    relabeled = dedup(torch.from_numpy(ranks % VOCAB).to(dev))
    zipf = torch.from_numpy(zipf_ids(rng, BATCH * FIELDS, VOCAB)).to(dev)
    w16 = torch.randn((VOCAB, 64), generator=gen, device=dev).to(
        torch.bfloat16)
    small = torch.randn((8, DIM + 1), generator=gen, device=dev)
    small_ids = torch.from_numpy(rng.integers(-2, 12, 5000)).to(dev)
    # 1,000,003 rows: the last window of 16 (and of 64) holds 3 rows;
    # sorted ids crowd the table's end, some past it
    partial = torch.randn((1_000_003, DIM + 1), generator=gen, device=dev)
    partial_ids = torch.from_numpy(np.sort(rng.integers(
        1_000_003 - 4000, 1_000_003 + 8, 20_000))).to(dev)
    dups = torch.from_numpy(rng.integers(0, 3000, 50_000)).to(dev)
    cases = [("dedup sorted", w32, dedup(ids), 16),
             ("dedup sorted", w32, dedup(ids), 64),
             ("relabeled dedup sorted", w32, relabeled, 16),
             ("relabeled dedup sorted", w32, relabeled, 64),
             ("zipf unsorted", w32, zipf, 16),
             ("zipf unsorted bf16", w16, zipf.to(torch.int32), 16),
             ("unsorted with duplicates", w32, dups, 16),
             ("last window partial", partial, partial_ids, 16),
             ("last window partial", partial, partial_ids, 64),
             ("table smaller than the window", small, small_ids, 16)]
    main = None
    for name, w, rows, window in cases:
        n_rows, dim = w.shape
        before = (gather.LAUNCHES["gather_rows"],
                  gather_windows.LAUNCHES["gather_rows_windows"])
        got = gather_windows.gather_rows_windows(w, rows, window=window)
        after = (gather.LAUNCHES["gather_rows"],
                 gather_windows.LAUNCHES["gather_rows_windows"])
        routed = (1, 0) if n_rows < window else (0, 1)
        check((after[0] - before[0], after[1] - before[1]) == routed,
              f"window gather {name}: launches {before} -> {after}")
        want = gather_windows.gather_rows_windows_reference(w, rows,
                                                            window=window)
        per_row = gather.gather_rows(w, rows)
        torch.cuda.synchronize()
        equal = (torch.equal(mb.bits(got), mb.bits(want))
                 and torch.equal(mb.bits(got), mb.bits(per_row)))
        err = max(float((got.float() - want.float()).abs().max()),
                  float((got.float() - per_row.float()).abs().max()))
        ids_np = rows.cpu().numpy()
        nbytes = mb.gather_bytes(ids_np, rows.element_size(), None, n_rows,
                                 dim, w.element_size())
        rec = {"phase": "windows", "case": name,
               "table": f"{str(w.dtype).split('.')[-1]} {n_rows}x{dim}",
               "ids": f"{rows.shape[0]} {str(rows.dtype).split('.')[-1]}",
               "window": window, "bit_equal": equal, "max_abs_err": err,
               "ms": mb.device_ms(lambda: gather_windows.gather_rows_windows(
                   w, rows, window=window)),
               "plain_ms": mb.device_ms(
                   lambda: gather_windows.gather_rows_windows_reference(
                       w, rows, window=window)),
               "gather_rows_ms": mb.device_ms(
                   lambda: gather.gather_rows(w, rows)),
               "library_ms": mb.device_ms(
                   lambda: mb.library_gather(w, rows)),
               **nbytes,
               "bound_ms": nbytes["useful_bytes"] / mb.HBM_BYTES_PER_S
               * 1e3}
        if n_rows >= window:
            rec["by_share"] = {}
            for share in STAGE_SHARES:
                # the rule changes how the kernel reads, never what it returns
                alt = gather_windows.gather_rows_windows(
                    w, rows, window=window, stage_share=share)
                torch.cuda.synchronize()
                same = torch.equal(mb.bits(alt), mb.bits(want))
                equal = equal and same
                st = gather_windows.staged_bytes(
                    ids_np, n_rows, dim * w.element_size(), window=window,
                    stage_share=share, base_offset=w.data_ptr() % 16)
                rec["by_share"][str(share)] = {
                    "bit_equal": same, **st._asdict(),
                    "ms": mb.device_ms(
                        lambda: gather_windows.gather_rows_windows(
                            w, rows, window=window, stage_share=share))}
        rec["bit_equal"] = equal
        emit(rec)
        check(equal, f"gather_rows_windows bit-equal to its plain version "
              f"and to gather_rows ({rec})")
        if main is None:
            main = rec
    # traced last (`kernels_profile`), so that no timed phase runs after a
    # profiler session
    calls = [(f"relabeled dedup sorted, stage_share {share}",
              lambda share=share: gather_windows.gather_rows_windows(
                  w32, relabeled, stage_share=share))
             for share in (float("inf"), 0.5)]
    return main, calls


def kernels_profile(torch, phase: str, calls, kernel: str) -> None:
    """Each call under torch.profiler, one a session: it must enqueue one
    device kernel, `kernel`, and nothing else (no prepass, no copy)."""
    for name, fn in calls:
        kernels, sessions = device_kernels(torch, fn)
        emit({"phase": phase, "case": f"profiler: {name}",
              "device_kernels_per_call": kernels,
              "profiler_sessions": len(sessions),
              "profiler_session_log": sessions})
        check(len(kernels) == 1 and kernel in kernels[0],
              f"one {phase} call enqueues one device kernel, {kernel} "
              f"({name}: {kernels}; sessions {sessions})")


def _apply_once(torch, mb, apply, opt, w, slots, idx, g, counts):
    """The kernel on (w, slots) and the plain version on clones; returns
    (kernel's, plain's) tables and slots after the update."""
    w2 = w.clone()
    s2 = {k: v.clone() for k, v in slots.items()}
    before = apply.LAUNCHES["fused_sparse_apply"]
    apply.fused_sparse_apply(opt, w, slots, idx, g, counts)
    check(apply.LAUNCHES["fused_sparse_apply"] == before + 1,
          "one fused_sparse_apply call is one kernel launch")
    apply.fused_sparse_apply_reference(opt, w2, s2, idx, g, counts)
    check(apply.LAUNCHES["fused_sparse_apply"] == before + 1,
          "the plain version launches no kernel")
    torch.cuda.synchronize()
    return (w, slots), (w2, s2)


def _max_err(got, want) -> float:
    (w, s), (w2, s2) = got, want
    errs = [float((w.float() - w2.float()).abs().max())]
    errs += [float((s[k] - s2[k]).abs().max()) for k in s]
    return max(errs)


def _bit_equal(torch, mb, got, want) -> bool:
    (w, s), (w2, s2) = got, want
    return (torch.equal(mb.bits(w), mb.bits(w2))
            and all(torch.equal(mb.bits(s[k]), mb.bits(s2[k])) for k in s))


def apply_small_cases(torch, mb, apply, sparse, optimizers) -> list:
    """Every rule on a small table: duplicates, -1 pads and out-of-range
    ids, three updates in a row (so the slots leave their initial values),
    the kernel held against the plain version after each."""
    dev = torch.device("cuda")
    cases = [
        ("default", optimizers.Default(learning_rate=0.1), torch.float32, 0.0),
        ("sgd", optimizers.SGD(learning_rate=0.05, momentum=0.9,
                               nesterov=True), torch.float32, 0.0),
        ("adagrad", optimizers.Adagrad(learning_rate=0.1), torch.float32, 0.0),
        ("adadelta", optimizers.Adadelta(learning_rate=0.5), torch.float32,
         0.0),
        ("adam", optimizers.Adam(learning_rate=0.01), torch.float32, 0.0),
        ("adamax", optimizers.Adamax(learning_rate=0.01), torch.float32, 0.0),
        ("ftrl", optimizers.Ftrl(learning_rate=0.05,
                                 l1_regularization_strength=0.01,
                                 l2_regularization_strength=0.01),
         torch.float32, 0.0),
        ("rmsprop", optimizers.RMSprop(learning_rate=0.05, momentum=0.5),
         torch.float32, 0.0),
        ("test", optimizers.TestOptimizer(), torch.float32, 0.0),
        ("adam bf16", optimizers.Adam(learning_rate=0.05), torch.bfloat16,
         0.0),
        # powf is not correctly rounded: the kernel and torch.pow may round
        # differently, by a few ulp of each power
        ("ftrl pow -0.7", optimizers.Ftrl(
            learning_rate=0.05, learning_rate_power=-0.7, beta=0.3,
            l1_regularization_strength=0.01,
            l2_shrinkage_regularization_strength=0.02), torch.float32, 1e-5),
    ]
    rng = np.random.default_rng(SEED + 2)
    n_rows, n = 1000, 600
    out = []
    for name, opt, dtype, tol in cases:
        dim = 16 if dtype == torch.bfloat16 else 12
        w = torch.from_numpy(rng.standard_normal((n_rows, dim)).astype(
            np.float32)).to(dev, dtype)
        slots = opt.init_slots(n_rows, dim, device=dev)
        worst, equal = 0.0, True
        for _ in range(3):
            ids = rng.integers(-1, n_rows + 100, n)
            ids[:50] = ids[50:100]  # certain duplicates
            grads = torch.from_numpy(rng.standard_normal((n, dim)).astype(
                np.float32)).to(dev)
            g, counts, idx = sparse._dedup_routed(
                n_rows, torch.from_numpy(ids).to(dev), grads, None)
            got, want = _apply_once(torch, mb, apply, opt, w, slots, idx, g,
                                    counts)
            worst = max(worst, _max_err(got, want))
            equal = equal and _bit_equal(torch, mb, got, want)
            w, slots = want  # continue from the plain version's state
        rec = {"phase": "apply", "case": name, "table": f"{n_rows}x{dim} "
               f"{str(dtype).split('.')[-1]}", "bit_equal": equal,
               "max_abs_err": worst, "tolerance": tol}
        emit(rec)
        if tol == 0.0:
            check(equal, f"fused_sparse_apply bit-equal to its plain version "
                  f"({rec})")
        else:
            check(worst <= tol, f"fused_sparse_apply within {tol} of its "
                  f"plain version ({rec})")
        out.append(rec)
    return out


def apply_packed_case(torch, mb, apply, gather, sparse, optimizers, data,
                      dim: int, n_rows: int) -> dict:
    """One Adagrad update of a criteo batch's rows through the packed
    weights+slots array against the split arrays (bit-equal), and the
    times that decide whether `train_many` should pack at this width (the
    gate refuses it on the card): the pull's gather and the apply in both
    layouts, and the pack and unpack that a window adds."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    opt = optimizers.Adagrad(learning_rate=0.05)
    w = 1e-2 * torch.randn((n_rows, dim), generator=gen, device=dev)
    accum = 0.1 + torch.rand((n_rows, dim), generator=gen, device=dev)
    batch = next(data.synthetic_criteo(BATCH, id_space=n_rows,
                                       seed=TRAIN_SEED))
    ids = torch.from_numpy(batch["sparse"]["categorical"].reshape(-1)).to(dev)
    grads = 1e-3 * torch.randn((ids.shape[0], dim), generator=gen,
                               device=dev)
    g, counts, idx = sparse._dedup_routed(n_rows, ids, grads, None)
    check(sparse.packed_layout(dim, {"accum": accum}) is None,
          f"the gate keeps the width-{dim} table split on the card")
    lay = (("accum", dim),)
    packed = sparse.pack_table(w, {"accum": accum}, lay)
    pw, ps = sparse.unpack_table(packed, lay, dim, torch.float32)
    split = {"accum": accum}
    apply.fused_sparse_apply(opt, w, split, idx, g, counts)
    apply.fused_sparse_apply(opt, pw, ps, idx, g, counts)
    torch.cuda.synchronize()
    equal = (torch.equal(mb.bits(w), mb.bits(pw.contiguous()))
             and torch.equal(mb.bits(accum), mb.bits(ps["accum"].contiguous())))
    pulled = gather.gather_rows(packed, ids)[:, :dim]
    equal = equal and torch.equal(mb.bits(pulled.contiguous()),
                                  mb.bits(gather.gather_rows(w, ids)))
    times = {
        "split_gather_ms": mb.device_ms(lambda: gather.gather_rows(w, ids)),
        "packed_gather_ms": mb.device_ms(
            lambda: gather.gather_rows(packed, ids)),
        "split_apply_ms": mb.device_ms(lambda: apply.fused_sparse_apply(
            opt, w, split, idx, g, counts)),
        "packed_apply_ms": mb.device_ms(lambda: apply.fused_sparse_apply(
            opt, pw, ps, idx, g, counts)),
        "pack_ms": mb.device_ms(
            lambda: sparse.pack_table(w, split, lay), samples=5),
    }

    def unpack():
        w.copy_(pw)
        accum.copy_(ps["accum"])

    times["unpack_ms"] = mb.device_ms(unpack, samples=5)
    per_step = {lay_name: times[f"{lay_name}_gather_ms"]
                + times[f"{lay_name}_apply_ms"]
                for lay_name in ("split", "packed")}
    rec = {"phase": "apply", "case": f"packed vs split, width {dim}",
           "table": f"f32 {n_rows}x{dim} + accum", "bit_equal": equal,
           **times,
           "window16_split_ms": MANY_STEPS * per_step["split"],
           "window16_packed_ms": MANY_STEPS * per_step["packed"]
           + times["pack_ms"] + times["unpack_ms"]}
    emit(rec)
    check(equal, f"packed apply and pull bit-equal to the split ones ({rec})")
    return rec


def _apply_edge_case(torch, mb, apply, sparse, rng, name, opt, dtype, dim,
                     layout="split", n_ids=3000, id_dtype="int64",
                     zero_counts=False) -> dict:
    """Two updates in a row of a 5000-row table, each the kernel on one copy
    against the plain version on another, every array bit-equal after each (with
    `zero_counts`, also bit-identical to before). layout: "split" (arrays
    of their own), "w[1:]" (every array a view one row in), or "off4" /
    "off8" (weights and the two slots of RMSprop as column views of one
    (n_rows, 52) array, the slots starting 4 / 8 bytes off a 16-byte
    boundary, the columns between them checked too)."""
    dev = torch.device("cuda")
    n_rows = 5000
    names = list(opt.slot_shapes(dim))
    if layout in ("off4", "off8"):
        offsets = (17, 34) if layout == "off4" else (18, 36)
        backing = [torch.from_numpy(rng.standard_normal((n_rows, 52)).astype(
            np.float32)).abs().to(dev)]

        def views(b):
            return b[0][:, :dim], {k: b[0][:, o:o + dim]
                                   for k, o in zip(names, offsets)}
    else:
        skip = 1 if layout == "w[1:]" else 0
        w = torch.from_numpy(rng.standard_normal(
            (n_rows + skip, dim)).astype(np.float32)).to(dev, dtype)
        backing = [w, *opt.init_slots(n_rows + skip, dim, device=dev).values()]

        def views(b):
            return b[0][skip:], {k: v[skip:] for k, v in zip(names, b[1:])}
    equal, worst, plans = True, 0.0, set()
    for update in range(2):
        ids = rng.integers(-1, n_rows + 50, n_ids)
        ids[:n_ids // 10] = ids[n_ids // 10:2 * (n_ids // 10)]  # duplicates
        ids[0] = n_rows // 2  # at least one live slot, also at n = 1
        grads = torch.from_numpy(rng.standard_normal((n_ids, dim)).astype(
            np.float32)).to(dev)
        g, counts, idx = sparse._dedup_routed(
            n_rows, torch.from_numpy(ids).to(dev, getattr(torch, id_dtype)),
            grads, None)
        if zero_counts:
            counts.zero_()
        got_b = [b.clone() for b in backing]
        want_b = [b.clone() for b in backing]
        (w, slots), (w2, s2) = views(got_b), views(want_b)
        arrays = apply.plan_arrays(opt, w, slots, g)
        plan = apply.launch_plan(opt.rule, dim, arrays)
        c_plan = apply.kernel_plan(opt.rule, dim, arrays)
        check((plan.word_elems, plan.tile_rows) == c_plan,
              f"{name}: launch_plan {plan} is the kernel's {c_plan}")
        plans.add((plan.word_elems, plan.tile_rows))
        before = apply.LAUNCHES["fused_sparse_apply"]
        apply.fused_sparse_apply(opt, w, slots, idx, g, counts)
        check(apply.LAUNCHES["fused_sparse_apply"] == before + 1,
              "one fused_sparse_apply call is one kernel launch")
        apply.fused_sparse_apply_reference(opt, w2, s2, idx, g, counts)
        torch.cuda.synchronize()
        for a, b in zip(got_b, want_b):
            equal = equal and torch.equal(mb.bits(a), mb.bits(b))
            worst = max(worst, float((a.float() - b.float()).abs().max()))
        if zero_counts:
            equal = equal and all(torch.equal(mb.bits(a), mb.bits(b))
                                  for a, b in zip(got_b, backing))
        backing = want_b  # continue from the plain version's state
    rec = {"phase": "apply", "case": name,
           "table": f"{n_rows}x{dim} {str(dtype).split('.')[-1]}",
           "layout": layout, "ids": id_dtype,
           "slots": int(idx.shape[0]),
           "plan_word_elems_tile_rows": sorted(plans), "bit_equal": equal,
           "max_abs_err": worst, "tolerance": 0.0}
    emit(rec)
    check(equal, f"fused_sparse_apply bit-equal to its plain version ({rec})")
    return rec


def apply_edge_cases(torch, mb, apply, sparse, optimizers) -> tuple:
    """What the kernel's lane map can get wrong: each word (E = 1, 2, 4) and
    partial tiles (widths 1 to 128), bfloat16 words, views off a 16-byte
    boundary, one slot, a ragged slot count, an update with no live slot,
    and the three rules with per-row state; returns the records and two
    calls for the profiler check."""
    rng = np.random.default_rng(SEED + 6)
    f32, bf16, i32 = torch.float32, torch.bfloat16, "int32"
    ada = optimizers.Adagrad(learning_rate=0.1)
    rms = optimizers.RMSprop(learning_rate=0.05, momentum=0.5)
    cases = [(f"adagrad width {d}", ada, f32, d, {}) for d in (1, 9, 10)]
    cases += [("adagrad width 11, int32 ids", ada, f32, 11,
               {"id_dtype": i32}),
              ("adagrad width 16", ada, f32, 16, {}),
              ("adagrad width 64, int32 ids", ada, f32, 64,
               {"id_dtype": i32}),
              ("adagrad width 128", ada, f32, 128, {}),
              ("adagrad bf16 width 10", ada, bf16, 10, {}),
              ("adagrad bf16 width 16", ada, bf16, 16, {}),
              ("rmsprop column views 4 bytes off", rms, f32, 16,
               {"layout": "off4"}),
              ("rmsprop column views 8 bytes off", rms, f32, 16,
               {"layout": "off8"}),
              ("adagrad view w[1:] width 10", ada, f32, 10,
               {"layout": "w[1:]"}),
              ("adagrad width 10, n = 1", ada, f32, 10, {"n_ids": 1}),
              ("adagrad width 10, n = 1001", ada, f32, 10,
               {"n_ids": 1001}),
              ("adagrad width 10, counts all 0", ada, f32, 10,
               {"zero_counts": True})]
    for rule, opt in (("adam", optimizers.Adam(learning_rate=0.01)),
                      ("adamax", optimizers.Adamax(learning_rate=0.01)),
                      ("test", optimizers.TestOptimizer())):
        cases += [(f"{rule} width {d}", opt, f32, d, {}) for d in (10, 64)]
    out = [_apply_edge_case(torch, mb, apply, sparse, rng, name, opt, dtype,
                            dim, **kw)
           for name, opt, dtype, dim, kw in cases]

    # one small call of each table type for the profiler, traced last
    dev = torch.device("cuda")
    calls = []
    adam = optimizers.Adam(learning_rate=0.01)
    for dtype, opt in ((f32, ada), (bf16, adam)):
        w = torch.randn((5000, 10), device=dev).to(dtype)
        slots = opt.init_slots(5000, 10, device=dev)
        ids = torch.from_numpy(rng.integers(0, 5000, 1001)).to(dev)
        g, counts, idx = sparse._dedup_routed(
            5000, ids, torch.randn((1001, 10), device=dev), None)
        calls.append((f"{type(opt).__name__} {str(dtype).split('.')[-1]} "
                      f"5000x10, 1001 slots",
                      lambda opt=opt, w=w, slots=slots, idx=idx, g=g,
                      counts=counts: apply.fused_sparse_apply(
                          opt, w, slots, idx, g, counts)))
    return out, calls


def phase_apply(torch, mb, apply, gather, sparse, optimizers, data) -> tuple:
    """The apply kernel against its plain version at the training path's
    shapes, its one-slot and all-padding times, warm and with L2 emptied,
    the packed cases, the lane map's edge cases and the small
    cases; returns the main case and the calls the profiler check traces
    once every timing is done."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    dim = DIM + 1
    opt = optimizers.Adagrad(learning_rate=0.05)
    w = 1e-2 * torch.randn((VOCAB, dim), generator=gen, device=dev)
    accum = opt.init_slots(VOCAB, dim, device=dev)["accum"]
    accum += torch.rand((VOCAB, dim), generator=gen, device=dev)
    batch = next(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                       seed=TRAIN_SEED))
    ids = torch.from_numpy(batch["sparse"]["categorical"].reshape(-1)).to(dev)
    grads = 1e-3 * torch.randn((ids.shape[0], dim), generator=gen, device=dev)
    g, counts, idx = sparse._dedup_routed(VOCAB, ids, grads, None)
    torch.cuda.synchronize()
    got, want = _apply_once(torch, mb, apply, opt, w, {"accum": accum}, idx,
                            g, counts)
    equal = _bit_equal(torch, mb, got, want)
    err = _max_err(got, want)
    del want
    w, slots = got

    rows_np = idx.cpu().numpy()
    counts_np = counts.cpu().numpy()
    nbytes = mb.apply_bytes(rows_np, counts_np, VOCAB, dim, w.element_size(),
                            [dim])
    arrays = apply.plan_arrays(opt, w, slots, g)
    plan = apply.launch_plan(opt.rule, dim, arrays)
    check((plan.word_elems, plan.tile_rows)
          == apply.kernel_plan(opt.rule, dim, arrays),
          "the main case's launch plan is the kernel's")
    tiles = -(-len(counts_np) // plan.tile_rows)
    live = np.zeros(tiles * plan.tile_rows, bool)
    live[:len(counts_np)] = counts_np > 0
    # the update with every count 0 leaves the table as it is
    zeros = torch.zeros_like(counts)
    before = (w.clone(), slots["accum"].clone())
    apply.fused_sparse_apply(opt, w, slots, idx, g, zeros)
    torch.cuda.synchronize()
    padding_equal = _bit_equal(torch, mb, (w, slots),
                               (before[0], {"accum": before[1]}))
    del before
    run = lambda: apply.fused_sparse_apply(opt, w, slots, idx, g, counts)
    one_slot = lambda: apply.fused_sparse_apply(opt, w, slots, idx[:1], g[:1],
                                                counts[:1])
    # a read of 256 MB, five times the H100's L2, before each cold call
    flush = torch.ones(1 << 26, device=dev)
    run_plain = lambda: apply.fused_sparse_apply_reference(
        opt, w, slots, idx, g, counts)
    rec = {
        "phase": "apply", "case": "main adagrad",
        "table": f"f32 {VOCAB}x{dim} + accum",
        "slots": int(idx.shape[0]), **nbytes,
        "plan": plan._asdict(), "tiles": tiles,
        "tiles_with_a_live_slot": int(live.reshape(
            tiles, plan.tile_rows).any(1).sum()),
        "bit_equal": equal,
        "all_padding_bit_identical": padding_equal,
        "max_abs_err": err,
        "ms": mb.device_ms(run),
        # one live slot: the floor of a launch; every slot padding: one
        # coalesced count and id round per tile
        "one_slot_ms": mb.device_ms(one_slot),
        "all_padding_ms": mb.device_ms(lambda: apply.fused_sparse_apply(
            opt, w, slots, idx, g, zeros)),
        # the same with the rows in DRAM: what the update takes above its
        # floor, against the sector bound
        "cold_ms": mb.device_ms(run, before=flush.sum),
        "cold_one_slot_ms": mb.device_ms(one_slot, before=flush.sum),
        "plain_ms": mb.device_ms(run_plain),
        "library_ms": mb.device_ms(mb.library_adagrad(opt, w, idx, g,
                                                      counts)),
        "host_ms_per_call": host_ms(torch, run),
        "bound_ms": nbytes["useful_bytes"] / mb.HBM_BYTES_PER_S * 1e3,
        "sector_bound_ms": nbytes["sector_bytes"] / mb.HBM_BYTES_PER_S * 1e3,
    }
    emit(rec)
    check(equal, f"fused_sparse_apply bit-equal to its plain version at "
          f"the main case ({rec})")
    check(padding_equal, "an update whose counts are all 0 leaves the "
          "table and its slots bit-identical")
    del w, slots, got, flush
    torch.cuda.empty_cache()
    rec["packed"] = [
        apply_packed_case(torch, mb, apply, gather, sparse, optimizers, data,
                          dim, VOCAB),
        apply_packed_case(torch, mb, apply, gather, sparse, optimizers, data,
                          64, 1 << 22)]
    torch.cuda.empty_cache()
    rec["edge_cases"], calls = apply_edge_cases(torch, mb, apply, sparse,
                                                optimizers)
    rec["small_cases"] = apply_small_cases(torch, mb, apply, sparse,
                                           optimizers)
    return rec, calls


def profile_device(torch, fn, calls: int = 10, unit: str = "predict"
                   ) -> dict:
    """Device busy time of `calls` calls of `fn` under torch.profiler: the
    sum of kernel and copy times on the card against the wall time, and the
    five costliest device ops, per call. The train step's `trainer.*`
    ranges appear twice: as host ranges (their host ms) and as annotations
    on the device timeline (the span from their first kernel to their
    last, idle gaps included); neither counts as device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    spans = [e for e in events if e.key.startswith("trainer.")]
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and e not in spans]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    check(busy_ms > 0, f"the profiler saw device work in {unit}")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    out = {"profile_calls": calls,
           f"profile_wall_ms_per_{unit}": wall_ms / calls,
           f"profile_device_ms_per_{unit}": busy_ms / calls,
           "profile_device_idle_share": 1.0 - busy_ms / wall_ms,
           "profile_top_device_ops": [
               [e.key[:60], e.self_device_time_total / 1e3 / calls,
                e.count // calls] for e in top]}
    if spans:
        out[f"profile_spans_ms_per_{unit}"] = {
            e.key + (" device span" if e.device_type == DeviceType.CUDA
                     else " host"):
            (e.device_time_total if e.device_type == DeviceType.CUDA
             else e.cpu_time_total) / 1e3 / calls for e in spans}
    return out


def phase_serve(torch, ops, gather) -> int:
    """Full-width DeepFM over REST; returns the gather launches of the run."""
    from openembedding_tpu_torch.export import export_standalone
    from openembedding_tpu_torch.model import init_weights
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.serving import ServingClient, make_server

    rng = np.random.default_rng(SEED + 1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    httpd = thread = None
    try:
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)
        t0 = time.perf_counter()
        state = init_weights(model, make_batch(rng, 8), seed=SEED)
        export_dir = os.path.join(tmp, "export")
        export_standalone(state, model, export_dir, model_sign=SIGN)
        export_s = time.perf_counter() - t0
        del state, model
        torch.cuda.empty_cache()

        httpd = make_server(os.path.join(tmp, "registry"), port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        client = ServingClient(f"http://127.0.0.1:{httpd.server_address[1]}",
                               timeout=300)

        # the main path's run: counts start at 0 here and are read below
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        client.create_model(SIGN, export_dir)
        load_s = time.perf_counter() - t0
        sm = httpd.manager.find_model(SIGN)
        n_tables = len(sm.variable_names)
        answers = []
        for b in (1, 100, BATCH):
            batch = make_batch(rng, b)
            before = gather.LAUNCHES["gather_rows"]
            logits = client.predict(SIGN, batch["sparse"], batch["dense"])
            delta = gather.LAUNCHES["gather_rows"] - before
            check(delta == n_tables, f"predict at batch {b} launched the "
                  f"gather {delta} times, expected {n_tables}")
            answers.append((batch, logits))
        pull_ids = [0, 7, 123456, VOCAB - 1, -1, VOCAB, VOCAB + 5, 1 << 40]
        before = gather.LAUNCHES["gather_rows"]
        pulled = client.pull(SIGN, "categorical", pull_ids)
        check(gather.LAUNCHES["gather_rows"] - before == 1,
              "a pull launches the gather once")

        big = answers[-1][0]
        rest = []
        for _ in range(10):
            t0 = time.perf_counter()
            client.predict(SIGN, big["sparse"], big["dense"])
            rest.append(time.perf_counter() - t0)

        def inproc():
            sm.predict(big)
            torch.cuda.synchronize()

        for _ in range(3):
            inproc()
        local = []
        for _ in range(30):
            t0 = time.perf_counter()
            inproc()
            local.append(time.perf_counter() - t0)
        profile = profile_device(torch, inproc)
        launches = gather.LAUNCHES["gather_rows"]

        # reference: the same servable, the plain gather in place of the kernel
        worst = 0.0
        with ops.plain_versions():
            for batch, logits in answers:
                ref = sm.predict(batch).float().cpu().numpy()
                n = batch["dense"].shape[0]
                check(logits.shape == (n,) and np.isfinite(logits).all(),
                      f"finite logits of shape ({n},)")
                err = float(np.abs(logits - ref).max())
                worst = max(worst, err)
                check(err == 0.0, f"REST logits at batch {n} equal the plain-"
                      f"gather forward (max abs err {err})")
            ref_rows = sm.lookup("categorical", np.asarray(pull_ids)).float(
            ).cpu().numpy()
        check(np.array_equal(pulled, ref_rows), "pulled rows equal the plain "
              "gather's")
        check(not pulled[4:].any() and pulled[:4].any(),
              "invalid ids pull zero rows, valid ones do not")
        rest_p50, local_p50 = np.median(rest), np.median(local)
        emit({"phase": "serve", "model": "deepfm vocab 2^24 dim 9 "
              "hidden 400-400-400 bf16", "tables": n_tables,
              "export_s": export_s, "load_s": load_s,
              "max_abs_err_vs_plain": worst, "tolerance": 0.0,
              "rest_p50_ms_4096": rest_p50 * 1e3,
              "rest_rows_per_s_4096": BATCH / rest_p50,
              "inproc_p50_ms_4096": local_p50 * 1e3,
              "inproc_rows_per_s_4096": BATCH / local_p50,
              "gather_launches": launches, **profile})
        check(launches > 0, "the serving run launched the gather kernel")
        return launches
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
            check(not thread.is_alive(), "the server thread stopped")
        shutil.rmtree(tmp, ignore_errors=True)


def _stacked(batches) -> dict:
    return {"sparse": {"categorical": np.stack(
                [b["sparse"]["categorical"] for b in batches])},
            "dense": np.stack([b["dense"] for b in batches]),
            "label": np.stack([b["label"] for b in batches])}


def _windows(batches) -> list:
    return [_stacked(batches[TRAIN_STEPS + w * MANY_STEPS:
                             TRAIN_STEPS + (w + 1) * MANY_STEPS])
            for w in range(MANY_WINDOWS)]


def _timed_steps(torch, step, state, batches, losses) -> tuple:
    """TRAIN_STEPS calls of `step`, the last TRAIN_STEPS - WARM_STEPS timed;
    each loss cloned (a captured step overwrites its outputs)."""
    for k in range(WARM_STEPS):
        state, m = step(state, batches[k])
        losses.append(m["loss"].clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(WARM_STEPS, TRAIN_STEPS):
        state, m = step(state, batches[k])
        losses.append(m["loss"].clone())
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def _run_windows(torch, many, state, windows, losses) -> tuple:
    """Every window through `many`; the last one timed."""
    seconds = 0.0
    for w, stacked in enumerate(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = many(state, stacked)
        losses.extend(m["loss"].clone().unbind(0))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(int(m["overflow"]) == 0, "no overflow on one device")
    return state, seconds


def by_id_bits(torch, mb, state) -> dict:
    """`mb.state_bits` with every hash table's resident rows (keys, weights,
    slots) in id order: a table loaded from a checkpoint may hold two
    colliding ids at each other's slots, and equals the saved one in its
    id -> row contents."""
    out = mb.state_bits(state)
    for name, t in state.tables.items():
        if t.keys is None:
            continue
        sel = torch.nonzero(t.keys >= 0).squeeze(1)
        rows = sel[torch.argsort(t.keys[sel])]
        out[f"{name}/keys"] = t.keys[rows]
        out[f"{name}/weights"] = t.weights[rows]
        out.update({f"{name}/{k}": v[rows] for k, v in t.slots.items()})
    return out


def _compare(torch, mb, state, losses, ref, ref_losses, what: str,
             by_id: bool = False) -> dict:
    bits = (lambda s: by_id_bits(torch, mb, s)) if by_id else mb.state_bits
    got, want = bits(state), bits(ref)
    check(got.keys() == want.keys() and all(
        got[k].shape == want[k].shape for k in got),
        f"{what}: the states hold the same tensors and shapes")
    diffs = {k: float((got[k].double() - want[k].double()).abs().max())
             if got[k].numel() else 0.0 for k in got}
    unequal = sorted(k for k in got if not torch.equal(mb.bits(got[k]),
                                                       mb.bits(want[k])))
    loss_equal = np.array_equal(losses.view(np.int32),
                                ref_losses.view(np.int32))
    out = {f"loss_bit_equal_{what}": bool(loss_equal),
           f"state_unequal_{what}": unequal,
           f"state_max_abs_diff_{what}": max(diffs.values())}
    check(loss_equal and not unequal, f"training equals the {what} run bit "
          f"for bit ({out})")
    return out


def graph_record(driver) -> dict:
    """What a `model.CompiledStep` has counted so far (copies: the driver
    counts on): captures, replays, the launches of one replay of each graph
    it keeps, and the launches its captures counted and its replays ran."""
    return {"captures": driver.captures, "replays": driver.replays,
            "graph_launches": driver.graph_launches,
            "launches_captured": dict(driver.launches_captured),
            "launches_replayed": dict(driver.launches_replayed)}


def row_launches(counted: dict) -> dict:
    """The row kernels' entries of a launch count: a path's gathers and
    applies, checked apart from the hash probe's kernels, which only the
    hashed paths launch."""
    return {k: counted[k] for k in KERNELS}


def ran_launches(counted: dict, graphs, captures: int = 1) -> dict:
    """The kernel launches that ran on the card in a run through CUDA-graph
    drivers, from their `graph_record`s: the wrappers' counts over the run
    less what each capture counted, since a captured launch runs nothing,
    plus what each replay ran. Each driver must have captured `captures`
    times, once per batch structure of the run, and kept every graph: a
    driver that captures again for a structure it has seen fails."""
    out = dict(counted)
    for d in graphs:
        check(d["captures"] == captures == len(d["graph_launches"]),
              f"{captures} capture(s) per driver, each graph kept ({d})")
        for k in out:
            out[k] += (d["launches_replayed"].get(k, 0)
                       - d["launches_captured"].get(k, 0))
    return out


def _pack_every_table(dim, slots, weights_dtype=None):
    """A gate that packs every table with slots, as the gate does off the
    card (the train phase's float32 Adagrad table is far below its cap)."""
    return tuple((k, int(slots[k].shape[1])) for k in sorted(slots))


def phase_train(torch, mb, ops, optimizers, data) -> dict:
    """Full-width DeepFM training through both kernels, held against the
    same steps through both plain versions and through the CUDA graphs."""
    from openembedding_tpu_torch import model as model_module
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm

    torch.cuda.reset_peak_memory_stats()
    model = make_deepfm(vocabulary=VOCAB, dim=DIM)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    steps = TRAIN_STEPS + MANY_WINDOWS * MANY_STEPS
    batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                         seed=TRAIN_SEED, steps=steps))
    windows = _windows(batches)
    state = trainer.init(batches[0])
    check(trainer._packed_layouts(state) == {},
          "the gate keeps the table split on the card")
    ref, graph_state = state.clone(), state.clone()
    n_tables = len(model.specs)
    to_np = lambda ls: torch.stack(ls).cpu().numpy()

    # the main path's run: counts start at 0 here and are read below
    ops.reset_launch_counts()
    losses = []
    state, seconds = _timed_steps(torch, trainer.train_step, state, batches,
                                  losses)
    state, many_seconds = _run_windows(torch, trainer.train_many, state,
                                       windows, losses)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for k in ("gather_rows", "fused_sparse_apply"):
        check(launches[k] == steps * n_tables, f"{k} launched {launches[k]} "
              f"times in {steps} steps of {n_tables} table(s)")
    losses = to_np(losses)
    check(np.isfinite(losses).all(), f"finite losses {losses}")

    # the same steps as eager train_steps through the plain versions: no
    # launch may be counted
    ref_losses = []
    with ops.plain_versions():
        ref, ref_seconds = _timed_steps(torch, trainer.train_step, ref,
                                        batches, ref_losses)
        for b in batches[TRAIN_STEPS:]:
            ref, m = trainer.train_step(ref, b)
            ref_losses.append(m["loss"])
    check(ops.launch_counts() == launches, "the plain run launched no kernel")
    rec = _compare(torch, mb, state, losses, ref, to_np(ref_losses),
                   "vs_plain")

    # the same steps through the CUDA graphs, the path's second run: counts
    # start at 0 here and are read below, as the graphs ran them
    step, many = trainer.jit_train_step(), trainer.jit_train_many()
    graph_losses = []
    ops.reset_launch_counts()
    graph_state, graph_seconds = _timed_steps(torch, step, graph_state,
                                              batches, graph_losses)
    packed_state = graph_state.clone()
    graph_state, graph_many_seconds = _run_windows(
        torch, many, graph_state, windows, graph_losses)
    graph = {"step": graph_record(step), "many": graph_record(many)}
    graph_launches = ran_launches(ops.launch_counts(), graph.values())
    for k in ("gather_rows", "fused_sparse_apply"):
        check(graph_launches[k] == steps * n_tables, f"{k} ran "
              f"{graph_launches[k]} times in {steps} graph steps of "
              f"{n_tables} table(s)")
    rec.update(_compare(torch, mb, graph_state, to_np(graph_losses), state,
                        losses, "graphs_vs_eager"))

    # the two windows again through a graph on the packed layout, which
    # the gate refuses on the card: held to the split steps and timed
    packed_losses = []
    with mock.patch.object(model_module, "packed_layout", _pack_every_table):
        packed_many = trainer.jit_train_many()
        check(trainer._packed_layouts(packed_state) == {
            "categorical": (("accum", DIM + 1),)}, "the window packs")
        packed_state, packed_seconds = _run_windows(
            torch, packed_many, packed_state, windows, packed_losses)
    rec.update(_compare(torch, mb, packed_state, to_np(packed_losses), state,
                        losses[TRAIN_STEPS:], "packed_graph_vs_eager"))
    graph["packed_many"] = graph_record(packed_many)
    for name, d in graph.items():
        calls, k = ((TRAIN_STEPS, 1) if name == "step"
                    else (MANY_WINDOWS, MANY_STEPS))
        check(d["captures"] == 1 and d["replays"] == calls - 1,
              f"jit_train_{name}: one capture, then replays ({d})")
        check([row_launches(g) for g in d["graph_launches"]] == [{
            "gather_rows": k * n_tables, "gather_rows_windows": 0,
            "fused_sparse_apply": k * n_tables}],
            f"each captured step launches one gather and one apply per "
            f"table ({d})")
    for st in (graph_state, packed_state):
        check(st.tables["categorical"].weights.shape == (VOCAB, DIM + 1)
              and list(st.tables["categorical"].slots) == ["accum"],
              "the state leaves train_many in the split layout")
    del packed_many, packed_state

    def one_step():
        trainer.train_step(state, batches[0])
        torch.cuda.synchronize()

    def one_replay():
        step(graph_state, batches[0])
        torch.cuda.synchronize()

    def one_window():
        many(graph_state, windows[0])
        torch.cuda.synchronize()

    profile = profile_device(torch, one_step, calls=5, unit="step")
    graph_profile = profile_device(torch, one_replay, calls=5, unit="step")
    many_profile = profile_device(torch, one_window, calls=3, unit="window")
    many_profile["profile_device_ms_per_step"] = (
        many_profile["profile_device_ms_per_window"] / MANY_STEPS)
    timed = TRAIN_STEPS - WARM_STEPS
    # the profiler slows the host; the idle share against the unprofiled
    # wall time of the timed steps is what a run without it sees
    for prof, wall_s, n in ((profile, seconds, timed),
                            (graph_profile, graph_seconds, timed),
                            (many_profile, graph_many_seconds, MANY_STEPS)):
        prof["device_idle_share_unprofiled"] = (
            1.0 - prof["profile_device_ms_per_step"] * n / (wall_s * 1e3))
    rec = {"phase": "train", "model": "deepfm vocab 2^24 dim 9 hidden "
           "400-400-400 bf16, Adagrad(0.05)", "batch": BATCH,
           "steps": steps, "launches": launches,
           "graph_launches": graph_launches,
           "losses": losses.tolist(),
           "loss_first_last": [float(losses[0]), float(losses[-1])],
           "examples_per_s": BATCH * timed / seconds,
           "step_ms": seconds * 1e3 / timed,
           "train_many_examples_per_s": BATCH * MANY_STEPS / many_seconds,
           "plain_examples_per_s": BATCH * timed / ref_seconds,
           "graph_step_examples_per_s": BATCH * timed / graph_seconds,
           "graph_step_ms": graph_seconds * 1e3 / timed,
           "graph_many_examples_per_s":
               BATCH * MANY_STEPS / graph_many_seconds,
           "graph_many_ms_per_step": graph_many_seconds * 1e3 / MANY_STEPS,
           "graph_packed_many_examples_per_s":
               BATCH * MANY_STEPS / packed_seconds,
           "graph_packed_many_ms_per_step":
               packed_seconds * 1e3 / MANY_STEPS,
           "graphs": graph, **rec,
           "peak_memory_bytes": peak, **profile,
           "graph_step_profile": graph_profile,
           "graph_many_profile": many_profile}
    emit(rec)
    return rec


EXAMPLE_BATCHES = 20      # the TSV: 20 x 4096 rows, one pass of the file
EXAMPLE_STEPS = 64        # each driving run; the file repeats (period 20)
EXAMPLE_K = 16            # --scan K: four windows of 16
CACHE_VOCAB = 1 << 20     # --cache: a 2^20 x 10 float32 sparse_as_dense table
CACHE_STEPS = 24
SAVE_STEPS = EXAMPLE_BATCHES  # save after one pass: the resumed run reads
                              # the batches the uninterrupted run reads next


def write_criteo_tsv(path: str, rows: int, seed: int) -> None:
    """Criteo-format rows from a seed, shaped like the day logs: a 0/1 label
    (25% clicks), 13 heavy-tailed integer counts (1% of them -1) and 26
    categorical 8-hex-digit tokens, Zipfian within each field; about 5% of
    the fields empty."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(rows) < 0.25).astype(np.int64)
    ints = np.floor(rng.pareto(1.5, (rows, NUM_DENSE)) * 3).astype(np.int64)
    ints[rng.random(ints.shape) < 0.01] = -1
    ranks = (rng.zipf(1.2, (rows, FIELDS)) - 1).astype(np.uint64)
    salt = np.arange(FIELDS, dtype=np.uint64) * np.uint64(0x9E3779B9)
    toks = (ranks * np.uint64(2654435761) + salt) & np.uint64(0xFFFFFFFF)
    empty = rng.random((rows, NUM_DENSE + FIELDS)) < 0.05
    with open(path, "w") as f:
        for r in range(rows):
            e = empty[r]
            cols = [str(labels[r])]
            cols += ["" if e[i] else str(v) for i, v in enumerate(ints[r])]
            cols += ["" if e[NUM_DENSE + i] else f"{int(t):08x}"
                     for i, t in enumerate(toks[r])]
            f.write("\t".join(cols) + "\n")


def _same_batches(a, b) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        pairs = [(x["label"], y["label"]), (x["dense"], y["dense"]),
                 (x["sparse"]["categorical"], y["sparse"]["categorical"])]
        if any(u.dtype != v.dtype or u.shape != v.shape
               or u.tobytes() != v.tobytes() for u, v in pairs):
            return False
    return True


def example_reader(data, tsv: str, gz: str) -> list:
    """The native and the Python engine on the TSV, and the native engine on
    its .gz copy: byte-identical batches, and each engine's rows/s (the
    native library built first, its build timed apart)."""
    from openembedding_tpu_torch import native as native_mod
    t0 = time.perf_counter()
    native_mod.load()
    build_s = time.perf_counter() - t0

    def read(path, engine):
        t0 = time.perf_counter()
        out = list(data.read_criteo_tsv(path, BATCH, id_space=VOCAB,
                                        native=engine))
        return out, time.perf_counter() - t0

    native, native_s = read(tsv, "on")
    python, python_s = read(tsv, "off")
    gzipped, gz_s = read(gz, "on")
    # the entry point's input as its loop sees it: the native reader
    # repeating the file through CriteoBatcher, past its first batch
    it = iter(data.CriteoBatcher(data.read_criteo_tsv(
        tsv, BATCH, id_space=VOCAB, repeat=True, native="on"), BATCH))
    next(it)
    t0 = time.perf_counter()
    for _ in range(EXAMPLE_STEPS):
        next(it)
    steady_ms = (time.perf_counter() - t0) * 1e3 / EXAMPLE_STEPS
    it.close()
    rows = EXAMPLE_BATCHES * BATCH
    same = _same_batches(native, python)
    same_gz = _same_batches(native, gzipped)
    emit({"phase": "example", "case": "reader", "rows": rows,
          "tsv_bytes": os.path.getsize(tsv), "gz_bytes": os.path.getsize(gz),
          "native_build_s": build_s,
          "batches": len(native),
          "native_rows_per_s": rows / native_s,
          "python_rows_per_s": rows / python_s,
          "native_gz_rows_per_s": rows / gz_s,
          "native_steady_ms_per_batch": steady_ms,
          "native_steady_rows_per_s": BATCH / steady_ms * 1e3,
          "native_vs_python_byte_identical": same,
          "gz_byte_identical": same_gz})
    check(len(native) == EXAMPLE_BATCHES and same and same_gz,
          "the native reader's batches (plain and .gz) are byte-identical "
          "to the Python reader's")
    return native


def _run_main(ops, ex, argv, captures: int = 1) -> tuple:
    """`ex.main(argv)`, the counts set to 0 just before and read just after
    -> (its result, the kernel launches that ran). `captures`: the batch
    structures of the run, each captured once by a graph driver."""
    from openembedding_tpu_torch.model import CompiledStep
    ops.reset_launch_counts()
    out = ex.main(argv)
    counted = ops.launch_counts()
    drv = out["driver"]
    if isinstance(drv, CompiledStep):
        out["graph"] = graph_record(drv)
        return out, ran_launches(counted, [out["graph"]], captures)
    return out, counted


def _driver_profile(torch, ex, out, batches, many: bool) -> dict:
    """The run's device busy time per step (its driver on more batches of
    the file, under torch.profiler, after the run was checked) and the idle
    share of its steady window against it."""
    drv, state = out["driver"], out["state"]
    arg = ex.stack_batches(batches[:EXAMPLE_K]) if many else batches[0]

    def call():
        drv(state, arg)
        torch.cuda.synchronize()

    prof = profile_device(torch, call, calls=3,
                          unit="window" if many else "step")
    busy = (prof["profile_device_ms_per_window"] / EXAMPLE_K if many
            else prof["profile_device_ms_per_step"])
    steady_ms = out["steady_seconds"] * 1e3
    return {"device_ms_per_step": busy,
            "device_idle_share": 1.0 - busy * out["steady_steps"] / steady_ms,
            "profile_top_device_ops": prof["profile_top_device_ops"]}


def _example_record(torch, mb, out, launches, ref_state, ref_losses,
                    what: str, steps: int, n_apply: int) -> dict:
    """A run's numbers, its losses and state held bit-equal to the plain
    run's (`ref_state` None: a run that stops early, whose losses are held
    to the plain run's first ones), and its launches checked: the model has
    one table, pulled by the gather each step and, unless it is
    sparse_as_dense (`n_apply` 0), pushed by the apply."""
    rec = {"run": what, "steps": out["steps"], "loss": out["loss"],
           "examples_per_s": out["examples_per_s"],
           "steady_examples_per_s": out["steady_examples_per_s"],
           "steady_ms_per_step": out["steady_seconds"] * 1e3
           / max(out["steady_steps"], 1),
           "train_auc": out["train_auc"], "launches": launches}
    if "graph" in out:
        rec["graph"] = out["graph"]
    if ref_state is None:
        equal = np.array_equal(out["losses"].view(np.int32),
                               ref_losses[:steps].view(np.int32))
        rec["loss_bit_equal_vs_plain"] = equal
        check(equal, f"{what}: losses equal the plain run's bit for bit")
    else:
        rec.update(_compare(torch, mb, out["state"], out["losses"],
                            ref_state, ref_losses, "vs_plain"))
    # the gather launches once more at init: the pass that materializes
    # the dense module pulls the first batch
    check(launches["gather_rows"] == steps + 1
          and launches["fused_sparse_apply"] == steps * n_apply
          and launches["gather_rows_windows"] == 0,
          f"{what}: launched one gather a step and one at init, and "
          f"{n_apply} apply a step ({launches})")
    return rec


def example_in_memory(torch, data, optimizers, batches) -> dict:
    """The copy alone, without the reader: `jit_train_step` over the file's
    batches already parsed (cycled), each batch copied (1) pageable by the
    step, (2) pinned by `prefetch_to_device`'s producer thread as the steps
    run, or (3) pinned by the same stager before the loop (all staged,
    no producer running: the floor of the pinned copy), in turns (1 2 3 3
    2 1), 64 timed steps each after 4 untimed."""
    import itertools

    from openembedding_tpu_torch.data.criteo import _PinnedStager
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    trainer = Trainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                      optimizers.Adagrad(learning_rate=0.05))
    state = trainer.init(batches[0])
    step = trainer.jit_train_step()
    modes = ("pageable", "pinned_prefetch", "pinned_staged_before")
    out = {f"{mode}_ms_per_step": [] for mode in modes}
    for mode in modes + modes[::-1]:
        it = itertools.cycle(batches)
        if mode == "pinned_prefetch":
            it = data.prefetch_to_device(it)
        elif mode == "pinned_staged_before":
            stager = _PinnedStager(torch.device("cuda"), EXAMPLE_STEPS + 4)
            staged = [stager.stage(next(it))
                      for _ in range(EXAMPLE_STEPS + 4)]
            torch.cuda.synchronize()
            it = (stager.hand_over(x) for x in staged)
        for _ in range(4):
            state, m = step(state, next(it))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXAMPLE_STEPS):
            state, m = step(state, next(it))
        torch.cuda.synchronize()
        out[f"{mode}_ms_per_step"].append(
            (time.perf_counter() - t0) * 1e3 / EXAMPLE_STEPS)
        if mode == "pinned_prefetch":
            it.close()
    check(np.isfinite(float(m["loss"])), "finite loss")
    emit({"phase": "example", "case": "graph step, batches in memory",
          **out})
    return out


def phase_example(torch, mb, ops, data, optimizers) -> dict:
    """The Criteo training entry point (`python -m
    openembedding_tpu_torch.examples.criteo_deepctr`) at full width on a
    Criteo TSV from a seed; -> {kernel: launches in the phase's runs}."""
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    from openembedding_tpu_torch.export import StandaloneModel

    tmp = tempfile.mkdtemp(prefix="chip_smoke-example-")
    total = {k: 0 for k in KERNELS}
    try:
        tsv, gz = os.path.join(tmp, "day.tsv"), os.path.join(tmp, "day.tsv.gz")
        t0 = time.perf_counter()
        write_criteo_tsv(tsv, EXAMPLE_BATCHES * BATCH, SEED + 3)
        with open(tsv, "rb") as f, gzip.open(gz, "wb", compresslevel=1) as g:
            shutil.copyfileobj(f, g)
        emit({"phase": "example", "case": "data", "write_s":
              time.perf_counter() - t0})
        batches = example_reader(data, tsv, gz)
        on_card = [{"sparse": {"categorical": torch.from_numpy(
                        b["sparse"]["categorical"]).cuda()},
                    "dense": torch.from_numpy(b["dense"]).cuda(),
                    "label": torch.from_numpy(b["label"]).cuda()}
                   for b in batches[:EXAMPLE_K]]

        def argv(steps, *extra, vocab=VOCAB):
            return ["--vocabulary", str(vocab), "--dim", str(DIM),
                    "--batch-size", str(BATCH), "--data", tsv,
                    "--steps", str(steps), *extra]

        def drive(args, what, ref, ref_losses, steps, n_apply=1,
                  profile=True):
            """One run of the entry point, checked; a run held to the
            whole plain run (`ref` given) is profiled too, unless told
            not to."""
            out, launches = _run_main(ops, ex, args)
            for k in KERNELS:
                total[k] += launches[k]
            rec = _example_record(torch, mb, out, launches, ref, ref_losses,
                                  what, steps, n_apply)
            if ref is not None and profile:
                prefetch = "--prefetch" in args
                rec.update(_driver_profile(
                    torch, ex, out, on_card if prefetch else batches,
                    "--scan" in args))
            return out, rec

        # the plain path: eager steps through both plain versions, no
        # prefetch; no launch may be counted
        ops.reset_launch_counts()
        with ops.plain_versions():
            ref = ex.main(argv(EXAMPLE_STEPS, "--eager"))
        check(sum(ops.launch_counts().values()) == 0,
              "the plain run launched no kernel")
        ref_state, ref_losses = ref["state"], ref["losses"]
        check(np.isfinite(ref_losses).all(), "finite losses")
        del ref
        runs = []
        order = [("eager", ["--eager"]), ("eager+prefetch",
                                          ["--eager", "--prefetch"]),
                 ("graph", []), ("graph+prefetch", ["--prefetch"]),
                 ("graph+prefetch", ["--prefetch"]), ("graph", []),
                 ("scan", ["--scan", str(EXAMPLE_K)]),
                 ("scan+prefetch", ["--scan", str(EXAMPLE_K), "--prefetch"]),
                 ("scan+prefetch", ["--scan", str(EXAMPLE_K), "--prefetch"]),
                 ("scan", ["--scan", str(EXAMPLE_K)])]
        for what, extra in order:
            # one profiler session per way of stepping: the repeat of each
            # is timed only
            out, rec = drive(argv(EXAMPLE_STEPS, *extra), what, ref_state,
                             ref_losses, EXAMPLE_STEPS,
                             profile=all(r["run"] != what for r in runs))
            emit({"phase": "example", "case": "train", **rec})
            runs.append(rec)
            del out
            torch.cuda.empty_cache()

        # save after one pass, load into a fresh state, continue: equal to
        # the uninterrupted plain run
        ckpt, export = os.path.join(tmp, "ckpt"), os.path.join(tmp, "export")
        first, _ = drive(argv(SAVE_STEPS, "--prefetch", "--save", ckpt,
                              "--export", export),
                         "graph+prefetch, save", None, ref_losses,
                         SAVE_STEPS)
        served = StandaloneModel.load(export)
        want = first["trainer"].eval_step(first["state"], batches[0])
        got = served.predict(batches[0])
        export_equal = torch.equal(got, want["logits"])
        check(export_equal, "the export's logits equal eval_step's")
        first_losses = first["losses"]
        del first, served
        torch.cuda.empty_cache()
        resumed, launched = _run_main(
            ops, ex, argv(EXAMPLE_STEPS - SAVE_STEPS, "--prefetch",
                          "--load", ckpt))
        for k in KERNELS:
            total[k] += launched[k]
        check(launched["gather_rows"] - 1 == launched["fused_sparse_apply"]
              == EXAMPLE_STEPS - SAVE_STEPS, f"the resumed run launched one "
              f"gather and one apply a step, and one gather at init "
              f"({launched})")
        losses = np.concatenate([first_losses, resumed["losses"]])
        resume = _compare(torch, mb, resumed["state"], losses, ref_state,
                          ref_losses, "save_load_continue_vs_uninterrupted")
        emit({"phase": "example", "case": "save, load, continue",
              "save_steps": SAVE_STEPS,
              "continue_steps": EXAMPLE_STEPS - SAVE_STEPS,
              "export_logits_equal_eval_step": export_equal, **resume})
        del resumed, ref_state
        torch.cuda.empty_cache()
        in_memory = example_in_memory(torch, data, optimizers, batches)
        torch.cuda.empty_cache()
        cache = example_cache(torch, mb, ops, ex, argv, drive, batches, tmp,
                              total)
        return {"launches": total, "runs": runs, "cache": cache,
                "in_memory": in_memory}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def example_cache(torch, mb, ops, ex, argv, drive, batches, tmp, total
                  ) -> dict:
    """--cache: the table as a 2^20 x 10 sparse_as_dense table (and its
    Adagrad accumulator), pulled by the gather kernel with a gradient and
    updated whole by the dense path; eager and graph drivers bit-equal to
    the plain path, checkpoint and export round-tripped."""
    from openembedding_tpu_torch.export import StandaloneModel
    cache = ["--cache", str(CACHE_VOCAB)]

    def args(steps, *extra):
        return argv(steps, *cache, *extra, vocab=CACHE_VOCAB)

    with ops.plain_versions():
        ref = ex.main(args(CACHE_STEPS, "--eager"))
    state = ref["state"]
    check(state.tables == {} and state.embeddings["categorical"].shape
          == (CACHE_VOCAB, DIM + 1), "the --cache table is sparse_as_dense")
    out = {}
    for what, extra in (("eager+prefetch", ["--eager", "--prefetch"]),
                        ("graph+prefetch", ["--prefetch"])):
        run, rec = drive(args(CACHE_STEPS, *extra), f"cache {what}", state,
                         ref["losses"], CACHE_STEPS, n_apply=0)
        if what.startswith("eager"):
            def one_step():
                run["trainer"].train_step(run["state"], batches[0])
            names, sessions = device_kernels(torch, one_step)
            rec["profiler_kernels_per_step"] = len(names)
            rec["profiler_sessions"] = len(sessions)
            rec["profiler_session_log"] = sessions
            rec["profiler_gather_kernels"] = [n[:60] for n in names
                                              if "gather_rows_kernel" in n]
            check(len(rec["profiler_gather_kernels"]) == 1,
                  f"the profiler sees the gather kernel on the "
                  f"sparse_as_dense pull ({len(names)} kernels, gathers "
                  f"{rec['profiler_gather_kernels']}, sessions {sessions})")
        emit({"phase": "example", "case": "cache train", **rec})
        out[what] = rec
        del run
        torch.cuda.empty_cache()
    ckpt, export = os.path.join(tmp, "ckpt_cache"), os.path.join(
        tmp, "export_cache")
    half = SAVE_STEPS  # one pass of the file, as for the flagship
    first, _ = drive(args(half, "--prefetch", "--save", ckpt, "--export",
                          export), "cache save", None, ref["losses"], half,
                     n_apply=0)
    served = StandaloneModel.load(export)
    export_equal = torch.equal(
        served.predict(batches[0]),
        first["trainer"].eval_step(first["state"], batches[0])["logits"])
    check(export_equal, "the --cache export's logits equal eval_step's")
    del first, served
    resumed, launched = _run_main(
        ops, ex, args(CACHE_STEPS - half, "--prefetch", "--load", ckpt))
    for k in KERNELS:
        total[k] += launched[k]
    check(launched["gather_rows"] == CACHE_STEPS - half + 1
          and launched["fused_sparse_apply"] == 0,
          f"the resumed --cache run launched one gather a step and one at "
          f"init ({launched})")
    losses = np.concatenate([ref["losses"][:half], resumed["losses"]])
    out["save_load_continue"] = _compare(
        torch, mb, resumed["state"], losses, state, ref["losses"],
        "cache_save_load_continue_vs_uninterrupted")
    out["export_logits_equal_eval_step"] = export_equal
    emit({"phase": "example", "case": "cache save, load, continue",
          **out["save_load_continue"],
          "export_logits_equal_eval_step": export_equal})
    return out


HASH_CAPACITY = 1 << 24   # the hashed flagship's slots (2^24 x 10 table)
HASH_ID_SPACE = 1 << 62   # the reader folds tokens into the hashed id space
HASH_STEPS = 64           # each way of stepping
HASH_SAVE = 20            # save after 20 steps, load, run the other 44
HASH_K = 16               # jit_train_many windows: four of 16
SMALL_STEPS = 8           # the small-capacity run that overflows
LOADED_FILL = 0.6         # the loaded run: the share of slots filled first
LOADED_STEPS = 20         # its steps: one pass of the file, new ids in each
LOADED_EAGER = 3          # its first steps, eager under the profiler


def _tsv_batches(data, tsv: str, id_space: int, steps: int) -> list:
    """`steps` batches of the TSV through the native reader, the file
    repeating, as the entry points read it."""
    it = iter(data.CriteoBatcher(data.read_criteo_tsv(
        tsv, BATCH, id_space=id_space, repeat=True, native="on"), BATCH))
    out = [next(it) for _ in range(steps)]
    it.close()
    return out


def _eager(torch, trainer, state, batches) -> tuple:
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        losses.append(m["loss"])
    return state, torch.stack(losses).cpu().numpy()


def _graph_steps(torch, step, state, batches) -> tuple:
    """`step` over the batches, its losses cloned; the steps after the
    first WARM_STEPS timed -> (state, losses, ms a step)."""
    losses = []
    for i, b in enumerate(batches):
        if i == WARM_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss"].clone())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - WARM_STEPS)
    return state, torch.stack(losses).cpu().numpy(), ms


def probe_profile(torch, fn, calls: int = 3) -> dict:
    """The hash probe's share of `calls` eager train steps under
    torch.profiler: the device kernels that start inside the device-side
    spans of the `hash.probe_insert` range (the step's one probe: the push
    takes the pull's slots), their summed time and their count, per
    step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith("hash.probe")]
    kernels = [e for e in events if not e.name.startswith(("hash.",
                                                          "trainer."))]
    inside = [e for e in kernels
              if any(a <= e.time_range.start < b for a, b in spans)]
    probe_us = sum(e.time_range.elapsed_us() for e in inside)
    step_us = sum(e.time_range.elapsed_us() for e in kernels)
    check(len(spans) == calls and probe_us > 0,
          f"the profiler saw one probe range a step ({len(spans)} spans)")
    return {"probe_device_ms_per_step": probe_us / 1e3 / calls,
            "probe_launches_per_step": len(inside) / calls,
            "step_device_ms_per_step": step_us / 1e3 / calls,
            "step_launches_per_step": len(kernels) / calls}


def new_ids_per_step(batches, resident=()) -> list:
    """How many of each batch's distinct ids no earlier batch (nor
    `resident`) held: the ids its pull inserts into a table that overflows
    nothing."""
    seen = np.asarray(resident, np.int64)
    out = []
    for b in batches:
        ids = np.unique(b["sparse"]["categorical"])
        ids = ids[ids >= 0]
        new = ids[~np.isin(ids, seen)]
        out.append(int(len(new)))
        seen = np.concatenate([seen, new])
    return out


def hash_loaded(torch, mb, ops, trainer, batches) -> dict:
    """The flagship's table filled to LOADED_FILL with seeded ids of the
    2^62 space before the run, as a day of Criteo fills it: one pass of the
    file (every step inserts ids) from it, the first LOADED_EAGER steps
    eager under the profiler (the probe's device time at this load), the
    rest through `jit_train_step` (timed), all bit-equal to the same steps
    through the plain versions; then the graph step's device ms."""
    from openembedding_tpu_torch.tables import hash_table
    state = trainer.init(batches[0])
    keys = state.tables["categorical"].keys
    rng = np.random.default_rng(SEED + 11)
    fill = np.unique(rng.integers(0, HASH_ID_SPACE,
                                  int(LOADED_FILL * HASH_CAPACITY)))
    fill_overflow = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for chunk in np.array_split(fill, 8):
        _, over = hash_table.hash_find_or_insert(
            keys, torch.as_tensor(chunk, device="cuda"))
        fill_overflow += int(over)
    fill_s = time.perf_counter() - t0
    load_before = int((keys >= 0).sum()) / HASH_CAPACITY
    ref = state.clone()
    runs = batches[:LOADED_STEPS]
    with ops.plain_versions():
        ref, ref_losses = _eager(torch, trainer, ref, runs)
    ops.reset_launch_counts()
    losses, it = [], iter(runs)

    def eager_step():
        nonlocal state
        state, m = trainer.train_step(state, next(it))
        losses.append(m["loss"])

    probe = probe_profile(torch, eager_step, calls=LOADED_EAGER)
    eager = ops.launch_counts()
    step = trainer.jit_train_step()
    ops.reset_launch_counts()
    state, graph_losses, graph_ms = _graph_steps(torch, step, state,
                                                 runs[LOADED_EAGER:])
    ran = ran_launches(ops.launch_counts(), [graph_record(step)])
    for k in ("gather_rows", "fused_sparse_apply"):
        check(eager[k] == LOADED_EAGER and
              ran[k] == LOADED_STEPS - LOADED_EAGER,
              f"the loaded run: one {k} a step ({eager}, {ran})")
    rec = _compare(torch, mb, state, np.concatenate(
        [torch.stack(losses).cpu().numpy(), graph_losses]), ref, ref_losses,
        "loaded_vs_plain")
    del ref

    def one_replay():
        step(state, runs[0])
        torch.cuda.synchronize()

    device_ms = profile_device(torch, one_replay, calls=5,
                               unit="step")["profile_device_ms_per_step"]
    out = {"fill_ids": int(len(fill)), "fill_overflow": fill_overflow,
           "fill_seconds": fill_s, "load_before": load_before,
           "load_after": int((keys >= 0).sum()) / HASH_CAPACITY,
           "steps": LOADED_STEPS, "new_ids_per_step": new_ids_per_step(runs),
           "overflow": trainer.table_overflow(state, "categorical"),
           "graph_ms_per_step": graph_ms,
           "graph_device_ms_per_step": device_ms,
           "graph_idle_share": 1.0 - device_ms / graph_ms, **probe, **rec,
           "launches": {k: eager[k] + ran[k] for k in KERNELS}}
    del state, step
    torch.cuda.empty_cache()
    return out


def hash_small_capacity(torch, mb, ops, optimizers, batches) -> dict:
    """A table of a quarter of one batch's unique ids: eager and graph steps
    through the kernels, bit-equal to the plain path, overflow equal and
    nonzero."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    ids = batches[0]["sparse"]["categorical"]
    capacity = len(np.unique(ids[ids >= 0])) // 4
    model = make_deepfm(VOCAB, DIM, hashed=True, capacity=capacity)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    base = trainer.init(batches[0])
    ref, graph_state = base.clone(), base.clone()
    with ops.plain_versions():
        ref, ref_losses = _eager(torch, trainer, ref, batches[:SMALL_STEPS])
    state, losses = _eager(torch, trainer, base, batches[:SMALL_STEPS])
    rec = _compare(torch, mb, state, losses, ref, ref_losses,
                   "small_capacity_vs_plain")
    step = trainer.jit_train_step()
    graph_state, graph_losses, _ = _graph_steps(
        torch, step, graph_state, batches[:SMALL_STEPS])
    rec.update(_compare(torch, mb, graph_state, graph_losses, ref,
                        ref_losses, "small_capacity_graph_vs_plain"))
    overflow = [trainer.table_overflow(s, "categorical")
                for s in (state, graph_state, ref)]
    check(overflow[0] == overflow[1] == overflow[2] > 0,
          f"the small table overflows alike on every path ({overflow})")
    return {"capacity": capacity, "steps": SMALL_STEPS,
            "overflow": overflow[0], **rec}


PROBE_CELL = "deepfm_d9_hashed"   # the benchmark's hashed configuration
PROBE_TRAFFIC = "criteo_zipf"      # and its traffic
PROBE_POOL_SEED = 3_000_000_024    # a seed of the size the benchmark draws


def _probe_records(got, want, what: str) -> dict:
    """(keys, slot, overflow, inserted, pending) of a kernel run against
    the plain run's: bit-equal, or the check fails."""
    import torch
    names = ("keys", "slot")
    for name, a, b in zip(names, got[:2], want[:2]):
        check(torch.equal(a, b), f"{what}: {name} bit-equal to the plain "
              "rounds")
    counts = {name: (int(a), int(b)) for name, a, b in zip(
        ("overflow", "inserted", "pending"), got[2:], want[2:])}
    check(all(a == b for a, b in counts.values()),
          f"{what}: counts equal to the plain rounds ({counts})")
    return {name: a for name, (a, _) in counts.items()}


def _probe_case(torch, mb, hash_probe, keys0, ids, num_probes, what: str,
                timed: bool = False) -> dict:
    """One probe of `ids` into copies of `keys0`: the kernels eager, then
    captured in a CUDA graph and replayed twice (the keys reset before
    each), each bit-equal to the plain rounds in keys, slots, overflow,
    inserted and pending; one walk and one contest a call, none at a
    replay. `timed`: the replay's device ms (keys reset before each, out of
    the timing) beside the plain call's."""
    from openembedding_tpu_torch.tables import hash_table
    plain_keys = keys0.clone()
    want = (plain_keys, *hash_table.hash_find_or_insert_reference(
        plain_keys, ids, num_probes))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eager_keys = keys0.clone()
    before = dict(hash_probe.LAUNCHES)
    got = (eager_keys, *hash_probe.find_or_insert(eager_keys, ids,
                                                  num_probes))
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - keys0.numel() * 8
    ran = {k: hash_probe.LAUNCHES[k] - before[k] for k in before}
    check(ran == {"hash_walk": 1, "hash_contest": 1},
          f"{what}: one walk and one contest a call ({ran})")
    rec = _probe_records(got, want, f"{what}, eager")
    del got, eager_keys
    graph_keys, static_ids = keys0.clone(), ids.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = dict(hash_probe.LAUNCHES)
    with torch.cuda.graph(graph, stream=stream):
        out = hash_probe.find_or_insert(graph_keys, static_ids, num_probes)
    captured = {k: hash_probe.LAUNCHES[k] - before[k] for k in before}
    check(captured == {"hash_walk": 1, "hash_contest": 1},
          f"{what}: the capture holds one walk and one contest ({captured})")
    before = dict(hash_probe.LAUNCHES)
    for replay in range(2):
        graph_keys.copy_(keys0)
        graph.replay()
        torch.cuda.synchronize()
        _probe_records((graph_keys, *out), want,
                       f"{what}, graph replay {replay}")
    check(hash_probe.LAUNCHES == before, f"{what}: a replay counts nothing")
    rec.update({"n": int(ids.numel()), "ids": int((ids >= 0).sum()),
                "capacity": int(keys0.numel()), "num_probes": num_probes,
                "kernel_extra_bytes": int(extra),
                "claim_buffer_bytes": int(keys0.numel()) * 4})
    check(extra < ids.numel() * 32 + (8 << 20), f"{what}: the kernels "
          f"allocate nothing of the table's size ({extra} bytes over the "
          "keys' copy)")
    if timed:
        rec["ms"] = mb.device_ms(graph.replay,
                                 before=lambda: graph_keys.copy_(keys0))
        plain = keys0.clone()
        rec["plain_ms"] = mb.device_ms(
            lambda: hash_table.hash_find_or_insert_reference(plain, ids,
                                                             num_probes),
            before=lambda: plain.copy_(keys0))
    del graph, out, graph_keys, want, plain_keys
    torch.cuda.empty_cache()
    return rec


def _walk_bound_ms(torch, keys, ids, slot) -> dict:
    """The walk's least time on the card: every id and slot moved once and
    each distinct 32-byte sector of keys from its base slot to its slot
    read once (the ids here are all present), at 3.35 TB/s."""
    from openembedding_tpu_torch.tables import hash_table
    live = ids >= 0
    cap = keys.numel()
    base = hash_table._base_slot(ids[live], cap)
    found = slot[live]
    check(bool((found < cap).all()), "every steady-state id is present")
    dist = torch.remainder(found - base, cap)
    reads = [torch.remainder(base + d, cap)[dist >= d]
             for d in range(int(dist.max()) + 1)]
    sectors = int(torch.unique(torch.cat(reads) // 4).numel())
    nbytes = sectors * 32 + ids.numel() * 8 * 2
    return {"sectors": sectors, "bytes": nbytes,
            "bound_ms": nbytes / 3.35e12 * 1e3,
            "distance_max": int(dist.max()),
            "distance_mean": float(dist.double().mean())}


def _probe_entries(torch, ids: np.ndarray):
    """A batch's ids -> its probe entries as the training pull makes them
    (`hash_lookup_train`): the dedup's unique ids, sorted, -1 in its
    padding slots; on the card."""
    from openembedding_tpu_torch.ops.dedup import unique_with_counts
    uniq = unique_with_counts(torch.as_tensor(ids.reshape(-1),
                                              device="cuda"))
    return torch.where(uniq.counts > 0, uniq.unique_ids,
                       torch.full_like(uniq.unique_ids, -1))


def phase_hash_probe(torch, mb, ops) -> dict:
    """The probe's kernels (`csrc/hash_probe.cu`) against the plain rounds
    on the card, eager and under graph replay, bit-equal in keys, slots,
    overflow, inserted and pending: the benchmark's steady state (the
    hashed cell's 2^28 slots filled by the pool of its traffic, batch by
    batch in the pool's order as its first pass fills them, by the kernels
    and by the plain rounds alike; then one pool batch's 106,496 probe
    entries, all present), all-new ids into an empty 2^20 table, a crowded
    2^12 table (contended slots, wrap-around, -1 pads, overflow at
    num_probes 16), and a 2^16 table with holes punched in front of
    present keys. Times the first pass's kernels, the steady probe and the
    all-new one beside the plain rounds and the walk's sector bound."""
    from benchmark import traffic
    from openembedding_tpu_torch.ops import hash_probe
    from openembedding_tpu_torch.tables import hash_table
    t0 = time.perf_counter()
    out = {"phase": "hash_probe"}
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "benchmark", "configs",
                           f"{PROBE_CELL}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(here, "benchmark", "traffic",
                           f"{PROBE_TRAFFIC}.json")) as f:
        mix = json.load(f)
    num = cfg["num_probes"]
    pool = traffic.make_pool(mix, cfg, PROBE_POOL_SEED)
    batches = [traffic.batch_of(pool, t)["sparse"]["categorical"]
               for t in range(mix["pool_batches"])]
    distinct = int(np.unique(np.concatenate(
        [b.reshape(-1) for b in batches])).size)
    del pool

    # the first pass: each pool batch's probe entries in turn, into the
    # kernels' table and into the plain rounds' table
    keys = hash_table.fresh_keys(cfg["capacity"], device="cuda")
    plain = hash_table.fresh_keys(cfg["capacity"], device="cuda")
    kernel_ms, fills = [], {"inserted": 0, "pending": 0, "overflow": 0}
    for ids in batches:
        probe = _probe_entries(torch, ids)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = (keys, *hash_probe.find_or_insert(keys, probe, num))
        end.record()
        want = (plain, *hash_table.hash_find_or_insert_reference(
            plain, probe, num))
        torch.cuda.synchronize()
        kernel_ms.append(start.elapsed_time(end))
        for k, v in _probe_records(got, want, "the first pass").items():
            fills[k] += v
    del plain, got, want
    torch.cuda.empty_cache()
    check(fills["inserted"] == fills["pending"] == distinct
          and fills["overflow"] == 0, f"the first pass claims one slot for "
          f"each of the pool's {distinct} distinct ids ({fills})")
    out["first_pass"] = {
        "batches": len(batches), "distinct": distinct,
        "load": int((keys >= 0).sum()) / cfg["capacity"],
        "kernel_ms_mean": float(np.mean(kernel_ms)),
        "kernel_ms_max": float(np.max(kernel_ms)),
        "kernel_ms_first": kernel_ms[0],
        "kernel_ms_last": kernel_ms[-1]}
    probe = _probe_entries(torch, batches[0])
    steady = _probe_case(torch, mb, hash_probe, keys, probe, num, "steady",
                         timed=True)
    check(steady["pending"] == steady["inserted"] == steady["overflow"] == 0,
          f"the steady state: every id found by the walk ({steady})")
    slot, _, _, _ = hash_probe.find_or_insert(keys, probe, num)
    steady.update(_walk_bound_ms(torch, keys, probe, slot))
    out["steady"] = steady
    del keys, probe, slot, batches
    torch.cuda.empty_cache()

    # all-new ids into an empty 2^20 table: half of it in one call
    rng = np.random.default_rng(SEED + 27)
    ids = np.unique(rng.integers(0, HASH_ID_SPACE, 1 << 19))
    ids = torch.as_tensor(np.concatenate([ids, np.full(4096, -1)]),
                          device="cuda")
    rec = _probe_case(torch, mb, hash_probe, hash_table.fresh_keys(
        1 << 20, device="cuda"), ids, num, "all_new", timed=True)
    check(rec["inserted"] == rec["pending"] == rec["ids"] and
          rec["overflow"] == 0, f"all-new: every id claims ({rec})")
    out["all_new"] = rec

    # crowded: 2^12 slots at load 0.7, then new ids, some of them based in
    # the last slots (their paths wrap), with -1 pads, at num_probes 16
    cap = 1 << 12
    rng = np.random.default_rng(SEED + 25)
    held = rng.permutation(np.unique(rng.integers(0, HASH_ID_SPACE,
                                                  int(cap * 0.75))))
    keys = hash_table.fresh_keys(cap, device="cuda")
    hash_table.hash_find_or_insert_reference(
        keys, torch.as_tensor(held[:int(cap * 0.7)], device="cuda"), num)
    # the last slots taken by ids of no probe and the first ones empty: a
    # path from the last slots wraps into the first
    keys[cap - 4:] = torch.as_tensor(held[-4:], device="cuda")
    keys[:4] = -1
    cand = np.unique(rng.integers(0, HASH_ID_SPACE, 1 << 20))
    based = (hash_table.np_mix(cand) % np.uint64(cap)).astype(np.int64)
    tail = cand[based >= cap - 4][:64]
    new = np.setdiff1d(np.concatenate([cand[:1500], tail]), held)
    ids = np.concatenate([np.full(50, -1), rng.permutation(new)])
    ids = torch.as_tensor(ids, device="cuda")
    rec = _probe_case(torch, mb, hash_probe, keys, ids, 16, "crowded")
    check(rec["overflow"] > 0 and 0 < rec["inserted"] < rec["pending"],
          f"crowded: contention and overflow ({rec})")
    work = keys.clone()
    slot, _, _, _ = hash_probe.find_or_insert(work, ids, 16)
    live = (ids >= 0) & (slot < cap)
    wrapped = int((slot[live] < hash_table._base_slot(ids[live], cap))
                  .sum())
    check(wrapped > 0, "crowded: some ids placed past the table's end")
    rec["wrapped"] = wrapped
    out["crowded"] = rec

    # holes: 2^16 slots at load 0.75, an empty slot punched at the base
    # slot of ids that sit further on, and a new id of that base for each
    # (later in the batch, it takes the hole and the old id finds itself
    # behind it; earlier, the old id claims the hole); others, new ones
    cap = 1 << 16
    rng = np.random.default_rng(SEED + 26)
    held = np.unique(rng.integers(0, HASH_ID_SPACE, int(cap * 0.76)))
    held = rng.permutation(held)[:int(cap * 0.75)]
    keys = hash_table.fresh_keys(cap, device="cuda")
    hslot, _, _, _ = hash_table.hash_find_or_insert_reference(
        keys, torch.as_tensor(held, device="cuda"), num)
    hslot = hslot.cpu().numpy()
    hbase = (hash_table.np_mix(held) % np.uint64(cap)).astype(np.int64)
    moved = np.flatnonzero(hslot != hbase)[:500]
    keys[torch.as_tensor(hbase[moved], device="cuda")] = -1
    cand = np.unique(rng.integers(0, HASH_ID_SPACE, 1 << 23))
    cbase = (hash_table.np_mix(cand) % np.uint64(cap)).astype(np.int64)
    first = np.unique(cbase, return_index=True)
    rival_of = dict(zip(first[0].tolist(), cand[first[1]].tolist()))
    rivals = np.array([rival_of[b] for b in hbase[moved].tolist()
                       if b in rival_of], np.int64)
    ids = np.unique(np.concatenate([held[moved], held[:3000], rivals,
                                    np.unique(rng.integers(
                                        0, HASH_ID_SPACE, 2000))]))
    ids = np.concatenate([rng.permutation(ids), np.full(30, -1)])
    rec = _probe_case(torch, mb, hash_probe, keys, torch.as_tensor(
        ids, device="cuda"), num, "holes")
    work = keys.clone()
    slot, _, _, _ = hash_probe.find_or_insert(
        work, torch.as_tensor(ids, device="cuda"), num)
    slot = slot.cpu().numpy()
    where = {k: i for i, k in enumerate(ids.tolist())}
    got = slot[[where[k] for k in held[moved].tolist()]]
    rec["found_behind_a_hole"] = int((got == hslot[moved]).sum())
    rec["claimed_the_hole"] = int((got == hbase[moved]).sum())
    check(rec["found_behind_a_hole"] > 0 and rec["claimed_the_hole"] > 0,
          f"holes: ids found behind a hole, others claimed it ({rec})")
    out["holes"] = rec
    del keys, work
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def phase_hash(torch, mb, ops, data, optimizers, tsv: str,
               array_graph: dict) -> dict:
    """The hashed flagship, `make_deepfm(1 << 24, 9, hashed=True, capacity=
    1 << 24)`, on the seeded TSV read into the 2^62 id space: eager steps,
    `jit_train_step` and `jit_train_many` windows, all bit-equal to the
    plain path; save, load and continue; export and serve; a small table
    that overflows; the probe's device time. -> {kernel: launches}."""
    from openembedding_tpu_torch.export import StandaloneModel, export_standalone
    from openembedding_tpu_torch.examples.criteo_deepctr import stack_batches
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.tables import hash_table

    torch.cuda.reset_peak_memory_stats()
    batches = _tsv_batches(data, tsv, HASH_ID_SPACE, HASH_STEPS)
    model = make_deepfm(VOCAB, DIM, hashed=True, capacity=HASH_CAPACITY)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    base = trainer.init(batches[0])
    ts = base.tables["categorical"]
    check(ts.keys.shape == (HASH_CAPACITY,) and ts.weights.shape == (
        HASH_CAPACITY, DIM + 1), "the hashed flagship's table")
    check(trainer._packed_layouts(base) == {},
          "the gate keeps the hash table split on the card")
    ref, state, graph_state, many_state, first = (base.clone()
                                                  for _ in range(5))
    del base
    total = {k: 0 for k in KERNELS + ("hash_walk",)}

    def counted():
        got = ops.launch_counts()
        for k in total:
            total[k] += got[k]
        return got

    ops.reset_launch_counts()
    with ops.plain_versions():
        ref, ref_losses = _eager(torch, trainer, ref, batches)
    check(sum(ops.launch_counts().values()) == 0,
          "the plain run launched no kernel")
    check(np.isfinite(ref_losses).all(), "finite losses")

    # the main path's runs: counts set to 0 just before each, read after
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = _eager(torch, trainer, state, batches)
    eager_ms = (time.perf_counter() - t0) * 1e3 / HASH_STEPS
    launches = counted()
    check(launches["gather_rows"] == launches["fused_sparse_apply"]
          == launches["hash_walk"] == launches["hash_contest"] == HASH_STEPS,
          f"one gather, one probe (walk and contest) and one apply a hashed "
          f"step ({launches})")
    rec = _compare(torch, mb, state, losses, ref, ref_losses, "vs_plain")

    step = trainer.jit_train_step()
    ops.reset_launch_counts()
    graph_state, graph_losses, graph_ms = _graph_steps(torch, step,
                                                       graph_state, batches)
    graph = {"step": graph_record(step)}
    ran = ran_launches(counted(), [graph["step"]])
    check(ran["gather_rows"] == ran["fused_sparse_apply"] == ran["hash_walk"]
          == ran["hash_contest"] == HASH_STEPS, f"the graph steps ran one "
          f"gather, one probe and one apply a step ({ran})")
    rec.update(_compare(torch, mb, graph_state, graph_losses, ref,
                        ref_losses, "graph_vs_plain"))

    many = trainer.jit_train_many()
    ops.reset_launch_counts()
    many_losses, overflow = [], 0
    for w in range(HASH_STEPS // HASH_K):
        if w == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        many_state, m = many(many_state, stack_batches(
            batches[w * HASH_K:(w + 1) * HASH_K]))
        many_losses.append(m["loss"].clone())
        overflow += int(m["overflow"])
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3 / (HASH_STEPS - HASH_K)
    graph["many"] = graph_record(many)
    ran = ran_launches(counted(), [graph["many"]])
    check(ran["gather_rows"] == ran["fused_sparse_apply"] == ran["hash_walk"]
          == ran["hash_contest"] == HASH_STEPS, f"the windows ran one "
          f"gather, one probe and one apply a step ({ran})")
    window = graph["many"]["graph_launches"][0]
    check(window.get("hash_walk") == window.get("hash_contest") == HASH_K,
          f"a window's graph holds {HASH_K} walks and contests ({window})")
    check(overflow == 0, f"no id overflows the flagship table ({overflow})")
    rec.update(_compare(torch, mb, many_state,
                        torch.cat(many_losses).cpu().numpy(), ref,
                        ref_losses, "many_vs_plain"))
    del many_state, many
    torch.cuda.empty_cache()

    # the probe: its share of an eager step under the profiler, and alone
    # (CUDA events) on one batch's ids against the trained keys
    probe = probe_profile(
        torch, lambda: trainer.train_step(state, batches[0]))
    flat = torch.as_tensor(batches[0]["sparse"]["categorical"],
                           device="cuda").reshape(-1)
    uniq = torch.unique(flat)
    keys = state.tables["categorical"].keys.clone()
    probe["probe_insert_ms_alone"] = mb.device_ms(
        lambda: hash_table.hash_find_or_insert(keys, uniq))
    probe["probe_find_ms_alone"] = mb.device_ms(
        lambda: hash_table.hash_find(keys, flat))
    del keys

    def one_replay():
        step(graph_state, batches[0])
        torch.cuda.synchronize()

    graph_profile = profile_device(torch, one_replay, calls=5, unit="step")
    device_ms = graph_profile["profile_device_ms_per_step"]

    # save after HASH_SAVE steps, load into a fresh state, run the rest:
    # the id -> row contents and the losses of the uninterrupted run
    tmp = tempfile.mkdtemp(prefix="chip_smoke-hash-")
    try:
        ckpt, export = os.path.join(tmp, "ckpt"), os.path.join(tmp, "export")
        ops.reset_launch_counts()
        first, first_losses = _eager(torch, trainer, first,
                                     batches[:HASH_SAVE])
        trainer.save(first, ckpt)
        del first
        torch.cuda.empty_cache()
        loaded = trainer.load(trainer.init(batches[0]), ckpt)
        check(trainer.table_overflow(loaded, "categorical") == 0,
              "every saved id loads")
        loaded, rest_losses = _eager(torch, trainer, loaded,
                                     batches[HASH_SAVE:])
        got = counted()
        check(got["gather_rows"] == got["fused_sparse_apply"] == HASH_STEPS,
              f"save, load, continue: one gather and one apply a step "
              f"({got})")
        rec.update(_compare(torch, mb, loaded, np.concatenate(
            [first_losses, rest_losses]), ref, ref_losses,
            "save_load_continue_vs_uninterrupted", by_id=True))
        del loaded
        torch.cuda.empty_cache()

        ops.reset_launch_counts()
        export_standalone(graph_state, model, export)
        served = StandaloneModel.load(export)
        logits = served.predict(batches[0])
        got = counted()
        check(got["gather_rows"] == 1, f"a predict launches one gather "
              f"({got})")
        want = trainer.eval_step(graph_state, batches[0])["logits"]
        export_equal = bool(torch.equal(logits, want))
        check(export_equal, "the hashed export's logits equal eval_step's")
        del served
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    del ref, graph_state, step
    torch.cuda.empty_cache()

    loaded = hash_loaded(torch, mb, ops, trainer, batches)
    for k in KERNELS:
        total[k] += loaded["launches"][k]
    ops.reset_launch_counts()
    small = hash_small_capacity(torch, mb, ops, optimizers, batches)
    counted()
    resident = int((state.tables["categorical"].keys >= 0).sum())
    new_ids = new_ids_per_step(batches)
    out = {"phase": "hash", "model": "deepfm hashed, capacity 2^24, dim 9, "
           "hidden 400-400-400 bf16, Adagrad(0.05); ids in 2^62",
           "batch": BATCH, "steps": HASH_STEPS, "resident_ids": resident,
           "load": resident / HASH_CAPACITY, "new_ids_per_step": new_ids,
           "steps_without_new_ids": sum(n == 0 for n in new_ids),
           "probe_profiled_new_ids": 0,  # batch 0 again: resident already
           "losses_first_last": [float(losses[0]), float(losses[-1])],
           "eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms,
           "graph_device_ms_per_step": device_ms,
           "graph_idle_share": 1.0 - device_ms / graph_ms,
           "graph_many_ms_per_step": many_ms,
           "array_flagship_graph": array_graph,
           "graph_profile_top_device_ops":
               graph_profile["profile_top_device_ops"],
           **probe, "graphs": graph, "export_logits_equal_eval_step":
           export_equal, "peak_memory_bytes": peak, **rec,
           "loaded": loaded, "small_capacity": small, "launches": total}
    emit(out)
    del state
    torch.cuda.empty_cache()
    return total


def phase_lr_example(torch, mb, ops) -> dict:
    """The hashed-LR example (`python -m
    openembedding_tpu_torch.examples.criteo_lr_subclass`) at its own
    settings, with --checkpoint and --save, then --load: bit-equal to the
    same run through the plain versions. -> {kernel: launches}."""
    from openembedding_tpu_torch.examples import criteo_lr_subclass as lr
    from openembedding_tpu_torch.model import Trainer
    tmp = tempfile.mkdtemp(prefix="chip_smoke-lr-")
    total = {k: 0 for k in KERNELS}
    try:
        ckpt, saved = os.path.join(tmp, "ckpt"), os.path.join(tmp, "saved")
        ops.reset_launch_counts()
        # the plain path: the example's steps as eager train_steps (the
        # plain apply reads its live rows back to the host, which a graph
        # cannot capture)
        with ops.plain_versions(), mock.patch.object(
                Trainer, "jit_train_step", lambda self: self.train_step):
            ref = lr.main([])
        check(sum(ops.launch_counts().values()) == 0,
              "the plain run launched no kernel")
        t0 = time.perf_counter()
        # a pass is three full batches and a padded one (100 rows, batch
        # 32): two batch structures, two graphs
        out, launches = _run_main(ops, lr, ["--checkpoint", ckpt,
                                            "--save", saved], captures=2)
        seconds = time.perf_counter() - t0
        steps = len(out["losses"])
        check(launches["gather_rows"] == launches["fused_sparse_apply"]
              == steps, f"one gather and one apply a step ({launches})")
        rec = _compare(torch, mb, out["state"], out["losses"], ref["state"],
                       ref["losses"], "vs_plain")
        check(not os.path.exists(os.path.join(saved, "dense_slots.npz"))
              and os.path.exists(os.path.join(ckpt, "dense_slots.npz")),
              "--save leaves the optimizer out, --checkpoint keeps it")
        resumed, more = _run_main(ops, lr, ["--load", ckpt, "--epochs", "1"],
                                  captures=2)
        check(resumed["state"].step == steps + len(resumed["losses"])
              and np.isfinite(resumed["losses"]).all()
              and more["gather_rows"] == more["fused_sparse_apply"]
              == len(resumed["losses"]), f"--load resumes ({more})")
        for k in KERNELS:
            total[k] = launches[k] + more[k]
        emit({"phase": "lr_example", "steps": steps,
              "resumed_steps": len(resumed["losses"]),
              "overflow": out["trainer"].table_overflow(out["state"],
                                                        "categorical"),
              "resident_ids": int((out["state"].tables["categorical"].keys
                                   >= 0).sum()),
              "losses": out["losses"].tolist(), "seconds": seconds,
              "graph": out["graph"], "launches": total, **rec})
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


ZOO = ("lr", "wdl", "xdeepfm", "dcn", "dlrm")
ZOO_STEPS = 16


def phase_zoo(torch, mb, ops, data, tsv: str) -> dict:
    """Every other CTR family through the Criteo entry point at full width
    (`--vocabulary 16777216 --dim 9 --batch-size 4096`): 16 eager and 16
    graph steps, each bit-equal to the plain path; the graph run's export
    served once over REST, its logits equal to eval_step's.
    -> {kernel: launches}."""
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    from openembedding_tpu_torch.serving import ServingClient, make_server

    batches = _tsv_batches(data, tsv, VOCAB, 2)
    total = {k: 0 for k in KERNELS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke-zoo-")
    httpd = make_server(os.path.join(tmp, "registry"), port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = ServingClient(f"http://127.0.0.1:{httpd.server_address[1]}",
                           timeout=300)
    try:
        for family in ZOO:
            args = ["--model", family, "--vocabulary", str(VOCAB), "--dim",
                    str(DIM), "--batch-size", str(BATCH), "--data", tsv,
                    "--steps", str(ZOO_STEPS)]
            ops.reset_launch_counts()
            with ops.plain_versions():
                ref = ex.main(args + ["--eager"])
            check(sum(ops.launch_counts().values()) == 0,
                  f"{family}: the plain run launched no kernel")
            check(np.isfinite(ref["losses"]).all(), f"{family}: finite")
            rec = {"phase": "zoo", "family": family,
                   "table": list(ref["state"].tables["categorical"]
                                 .weights.shape)}
            export = os.path.join(tmp, f"export_{family}")
            for what, extra in (("eager", ["--eager"]),
                                ("graph", ["--export", export])):
                out, launches = _run_main(ops, ex, args + extra)
                for k in KERNELS:
                    total[k] += launches[k]
                run = _example_record(torch, mb, out, launches, ref["state"],
                                      ref["losses"], f"{family} {what}",
                                      ZOO_STEPS, 1)
                rec[what] = run
                if what == "graph":  # served before the profile steps on
                    sign = f"{family}-smoke"
                    ops.reset_launch_counts()
                    client.create_model(sign, export)
                    b = batches[1]
                    served = client.predict(sign, b["sparse"], b["dense"])
                    got = ops.launch_counts()
                    for k in KERNELS:
                        total[k] += got[k]
                    want = out["trainer"].eval_step(out["state"], b)[
                        "logits"].float().cpu().numpy()
                    equal = bool(np.array_equal(served, want))
                    rec["rest_logits_equal_eval_step"] = equal
                    rec["rest_max_abs_err"] = float(
                        np.abs(served - want).max())
                    check(equal and got["gather_rows"] == 1,
                          f"{family}: REST logits equal eval_step's "
                          f"({rec['rest_max_abs_err']}), one gather ({got})")
                run.update(_driver_profile(torch, ex, out, batches, False))
                del out
                torch.cuda.empty_cache()
            emit(rec)
            del ref
            torch.cuda.empty_cache()
        return total
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        check(not thread.is_alive(), "the server thread stopped")
        shutil.rmtree(tmp, ignore_errors=True)


MESH_STAGED = 4           # ranks of the staged run on the one card (gloo)
MESH_STAGED_STEPS = 4     # its eager steps per wire format
MESH_HASH_STEPS = 2       # the hashed flagship's steps at 4 ranks
MESH_ENTRY_SAVE = EXAMPLE_BATCHES  # the entry point saves after one pass
MESH_ENTRY_STEPS = 16     # then loads and runs 16 more


def _mesh_launches(counted: dict) -> dict:
    check(counted["gather_rows_windows"] == 0,
          f"the mesh path launches no window gather ({counted})")
    return row_launches(counted)


def mesh_one(torch, mb, ops, data, optimizers, array_graph) -> dict:
    """`case_mesh1` at full width: `make_deepfm(2^24, 9)` through
    MeshTrainer on a one-rank NCCL group, the train phase's batches: eager
    steps and windows, the plain versions, both graph drivers; against the
    single-device Trainer from the same state."""
    import torch.distributed as dist
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer, make_mesh
    from openembedding_tpu_torch.parallel import multihost

    tmp = tempfile.mkdtemp(prefix="chip_smoke-pg-")
    multihost.initialize("nccl", init_file=os.path.join(tmp, "store"),
                         rank=0, world_size=1)
    try:
        mesh = make_mesh()
        check(mesh.size == 1 and mesh.backend == "nccl",
              f"a one-rank NCCL mesh ({mesh})")
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)
        trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                              mesh=mesh)
        steps = TRAIN_STEPS + MANY_WINDOWS * MANY_STEPS
        batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                             seed=TRAIN_SEED, steps=steps))
        windows = _windows(batches)
        state = trainer.init(batches[0])
        check(state.tables["categorical"].weights.shape == (VOCAB, DIM + 1),
              "one shard of one rank is the whole table")
        ref, graph_state, single_state = (state.clone(), state.clone(),
                                          state.clone())
        to_np = lambda ls: torch.stack(ls).cpu().numpy()

        ops.reset_launch_counts()  # the path's run: counts read just after
        losses = []
        state, seconds = _timed_steps(torch, trainer.train_step, state,
                                      batches, losses)
        state, _ = _run_windows(torch, trainer.train_many, state, windows,
                                losses)
        launches = _mesh_launches(ops.launch_counts())
        for k in ("gather_rows", "fused_sparse_apply"):
            check(launches[k] == steps, f"mesh1: {k} launched "
                  f"{launches[k]} times in {steps} steps")
        losses = to_np(losses)
        check(np.isfinite(losses).all(), "mesh1: finite losses")

        ref_losses = []
        with ops.plain_versions():
            for b in batches:
                ref, m = trainer.train_step(ref, b)
                ref_losses.append(m["loss"])
        rec = _compare(torch, mb, state, losses, ref, to_np(ref_losses),
                       "vs_plain")

        step, many = trainer.jit_train_step(), trainer.jit_train_many()
        graph_losses = []
        ops.reset_launch_counts()
        graph_state, graph_seconds = _timed_steps(torch, step, graph_state,
                                                  batches, graph_losses)
        graph_state, many_seconds = _run_windows(torch, many, graph_state,
                                                 windows, graph_losses)
        graphs = {"step": graph_record(step), "many": graph_record(many)}
        graph_launches = _mesh_launches(ran_launches(
            ops.launch_counts(), graphs.values()))
        for k in ("gather_rows", "fused_sparse_apply"):
            check(graph_launches[k] == steps, f"mesh1 graphs: {k} ran "
                  f"{graph_launches[k]} times in {steps} steps")
        rec.update(_compare(torch, mb, graph_state, to_np(graph_losses),
                            state, losses, "graphs_vs_eager"))

        # the single-device Trainer from the same state
        single = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
        single_losses = []
        for b in batches:
            single_state, m = single.train_step(single_state, b)
            single_losses.append(m["loss"])
        got, want = mb.state_bits(state), mb.state_bits(single_state)
        diffs = {k: float((got[k].double() - want[k].double()).abs().max())
                 for k in got}
        single_losses = to_np(single_losses)
        rec["vs_single_device_max_abs_diff"] = max(diffs.values())
        rec["vs_single_device_loss_max_abs_diff"] = float(
            np.abs(losses - single_losses).max())
        rec["vs_single_device_bit_equal"] = bool(
            all(torch.equal(mb.bits(got[k]), mb.bits(want[k])) for k in got)
            and np.array_equal(losses.view(np.int32),
                               single_losses.view(np.int32)))

        def one_replay():
            step(graph_state, batches[0])
            torch.cuda.synchronize()

        prof = profile_device(torch, one_replay, calls=5, unit="step")
        timed = TRAIN_STEPS - WARM_STEPS
        graph_ms = graph_seconds * 1e3 / timed
        rec.update({
            "run": "mesh1", "steps": steps, "launches": launches,
            "graph_launches": graph_launches, "graphs": graphs,
            "loss_first_last": [float(losses[0]), float(losses[-1])],
            "eager_ms_per_step": seconds * 1e3 / timed,
            "graph_step_ms": graph_ms,
            "graph_many_ms_per_step": many_seconds * 1e3 / MANY_STEPS,
            "graph_step_device_ms": prof["profile_device_ms_per_step"],
            "graph_step_idle_share": 1.0 - prof[
                "profile_device_ms_per_step"] / graph_ms,
            "graph_step_top_device_ops": prof["profile_top_device_ops"],
            "array_flagship_graph_in_memory": array_graph["in_memory"]})
        del state, ref, graph_state, single_state, step, many
        return rec
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _staged_run(torch, mb, ops, trainer, state, batches):
    """Eager steps on this rank, counts set to 0 just before and read just
    after, then the same steps through the plain versions from a clone,
    bit-equal -> (state, losses, launches, ms a step, staged bytes a step,
    the comparison)."""
    ref = state.clone()
    mesh = trainer.mesh
    ops.reset_launch_counts()
    staged0 = mesh.staged_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    launches = _mesh_launches(ops.launch_counts())
    staged = (mesh.staged_bytes - staged0) / len(batches)
    ref_losses = []
    with ops.plain_versions():
        for b in batches:
            ref, m = trainer.train_step(ref, b)
            ref_losses.append(m["loss"])
    losses = torch.stack(losses).cpu().numpy()
    cmp = _compare(torch, mb, state, losses, ref,
                   torch.stack(ref_losses).cpu().numpy(), "vs_plain")
    return state, losses, launches, ms, staged, cmp


def mesh_staged_rank(mesh):
    """One rank of the staged run (gloo, its tensors on the card): the
    flagship at both wire formats, then the hashed flagship. Returns numpy
    and plain numbers only."""
    import torch
    from openembedding_tpu_torch import data, ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(mesh.staged and mesh.size == MESH_STAGED, f"a staged mesh {mesh}")
    out = {"rank": mesh.rank, "runs": []}
    globals_ = list(data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED, steps=MESH_STAGED_STEPS))
    batches = [local_batch(b, mesh) for b in globals_]
    for wire in ("fp32", None):
        # a float32 tower: its products do not round with the batch size,
        # so step 0 holds to the single-device run's at the fp32 bound
        model = make_deepfm(vocabulary=VOCAB, dim=DIM,
                            compute_dtype=torch.float32)
        trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                              mesh=mesh, wire=wire)
        state = trainer.init(batches[0])
        check(state.tables["categorical"].weights.shape
              == (VOCAB // MESH_STAGED, DIM + 1), "a rank holds one shard")
        state, losses, launches, ms, staged, cmp = _staged_run(
            torch, mb, ops, trainer, state, batches[:1])
        # step 0's rows of the ids this rank owns, for the parent's
        # single-device run
        g = np.unique(globals_[0]["sparse"]["categorical"])
        own = g[g % mesh.size == mesh.rank]
        rows0 = state.tables["categorical"].weights[
            torch.from_numpy(own // mesh.size).to(mesh.device)].cpu().numpy()
        state, more, more_launches, ms, staged, cmp2 = _staged_run(
            torch, mb, ops, trainer, state, batches[1:])
        out["runs"].append({
            "wire": trainer.wire_for("categorical"),
            "losses": np.concatenate([losses, more]).tolist(),
            "launches": {k: launches[k] + more_launches[k]
                         for k in launches},
            "ms_per_step": ms, "staged_bytes_per_step": staged,
            "step0_ids": own, "step0_rows": rows0, **cmp,
            **{k + "_later": v for k, v in cmp2.items()}})
        del trainer, state
        torch.cuda.empty_cache()
    hashed = list(data.synthetic_criteo(BATCH, id_space=HASH_ID_SPACE,
                                        seed=TRAIN_SEED,
                                        steps=MESH_HASH_STEPS))
    model = make_deepfm(VOCAB, DIM, hashed=True, capacity=HASH_CAPACITY)
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                          mesh=mesh)
    hb = [local_batch(b, mesh) for b in hashed]
    state = trainer.init(hb[0])
    check(state.tables["categorical"].keys.shape
          == (HASH_CAPACITY // MESH_STAGED,), "a rank holds one hash shard")
    state, losses, launches, ms, staged, cmp = _staged_run(
        torch, mb, ops, trainer, state, hb)
    ts = state.tables["categorical"]
    out["runs"].append({
        "wire": "hash " + trainer.wire_for("categorical"),
        "losses": losses.tolist(), "launches": launches, "ms_per_step": ms,
        "staged_bytes_per_step": staged,
        "resident": int((ts.keys >= 0).sum()),
        "overflow": int(ts.overflow), **cmp})
    return out


def _step0_single(torch, optimizers, data):
    """The single-device Trainer's step 0 from the staged run's initial
    state (its shards drawn again here from their generators, in id
    order), its loss scaled by S -> (the table after the step, the loss /
    S)."""
    from openembedding_tpu_torch.embedding import init_table_state
    from openembedding_tpu_torch.model import (Trainer, _table_generator,
                                               binary_logloss)
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel.sharded import deinterleave_rows
    S = MESH_STAGED
    model = make_deepfm(vocabulary=VOCAB, dim=DIM,
                        compute_dtype=torch.float32)
    model.loss_fn = lambda lo, la, w=None: S * binary_logloss(lo, la, w)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    batch = next(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                       seed=TRAIN_SEED, steps=1))
    state = trainer.init(batch)
    spec = model.specs["categorical"]
    shards = [init_table_state(spec, trainer.opt_for(spec), _table_generator(
        trainer.seed, spec, trainer.device, (r, S)), num_shards=S).weights
              for r in range(S)]
    state.tables["categorical"].weights.copy_(
        deinterleave_rows(torch.cat(shards), S, VOCAB))
    del shards
    state, m = trainer.train_step(state, batch)
    w = state.tables["categorical"].weights
    return w, float(m["loss"]) / S


def mesh_staged(torch, optimizers, data) -> dict:
    """Four ranks on the one card over gloo, staged through the host."""
    from openembedding_tpu_torch.parallel.multihost import run_local
    t0 = time.perf_counter()
    ranks = run_local(mesh_staged_rank, MESH_STAGED, backend="gloo",
                      device="cuda", timeout_s=600, threads=0)
    wall = time.perf_counter() - t0
    w, loss = _step0_single(torch, optimizers, data)
    rec = {"run": "mesh4-staged", "ranks": MESH_STAGED,
           "wall_seconds": wall, "per_rank": []}
    worst = 0.0
    for out in ranks:
        for run in out["runs"]:
            for k in ("gather_rows", "fused_sparse_apply"):
                check(run["launches"][k] > 0, f"rank {out['rank']} "
                      f"({run['wire']}) launched {k}")
            if "step0_ids" in run:
                want = w[torch.from_numpy(run["step0_ids"]).to(w.device)]
                got = torch.from_numpy(run["step0_rows"]).to(w.device)
                diff = float((got - want).abs().max())
                run["step0_vs_single_device_max_abs_diff"] = diff
                run["step0_loss_vs_single_device"] = [run["losses"][0],
                                                      loss]
                del run["step0_ids"], run["step0_rows"]
                # the bf16 wire rounds the pulled rows and the pushed
                # grads: only the fp32 wire is held to the fp32 bound
                if run["wire"] == "fp32":
                    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
                          f"rank {out['rank']}: step-0 rows within rtol "
                          "1e-5 / atol 1e-6 of the single-device Trainer "
                          f"with its loss scaled by S ({diff})")
                    check(abs(run["losses"][0] - loss) <= 1e-5 * abs(loss),
                          f"rank {out['rank']}: step-0 loss "
                          f"{run['losses'][0]} against {loss}")
                    worst = max(worst, diff)
            rec["per_rank"].append({"rank": out["rank"], **run})
    rec["step0_fp32_vs_single_device_max_abs_diff"] = worst
    del w
    return rec


PLACE_STEPS = 4           # eager steps of each placement configuration
PLACE_HOT = 1024          # hot rows: the run's 1,024 most frequent ids
PLACE_MIG = 256           # migration annex rows
# name -> MeshTrainer arguments; each run installs its placement through
# `place`: the hot set before step 0, the moves before step 1
PLACE_CONFIGS = {
    "a int8+ef": dict(wire="int8"),
    "b hot fp32": dict(wire="fp32", hot_rows=PLACE_HOT),
    "c mig fp32": dict(wire="fp32", mig_rows=PLACE_MIG),
    "d int8 hot mig hot_wire int8": dict(
        wire="int8", hot_rows=PLACE_HOT, mig_rows=PLACE_MIG,
        hot_wire="int8"),
}


def _imbalance(positions) -> float:
    p = np.asarray(positions, np.float64)
    return float(p.max() / p.mean())


def place_run(torch, trainer, state, batches, hot_ids, moves):
    """The placement run's steps on this rank: the hot set (if any) before
    step 0, the moves (if any; `moves(stats of step 0)` gives them) before
    step 1 -> (state, losses (n,) numpy, the steps' stats as numpy, the
    moves)."""
    if trainer.hot_enabled:
        state = trainer.refresh_hot_rows(state,
                                         hot_ids={"categorical": hot_ids})
    losses, stats, made = [], [], None
    for k, b in enumerate(batches):
        if k == 1 and trainer.mig_enabled:
            made = moves(stats[0])
            state = trainer.migrate_rows(state, moves={"categorical": made})
        state, m = trainer.train_step(state, b)
        losses.append(m["loss"])
        stats.append({key: v.cpu().numpy() for key, v in m["stats"].items()})
    return state, torch.stack(losses).cpu().numpy(), stats, made


def _table_bits(torch, mb, state) -> dict:
    """The state's tensors a run without placement also holds (its own
    placement state left out)."""
    return {k: v for k, v in mb.state_bits(state).items()
            if "/hot/" not in k and "/mig/" not in k
            and not k.endswith("/ef")}


def _save_files(path) -> dict:
    """{file: bytes} of a sharded save; an .npz by its arrays' bytes (a zip
    member carries its write time), `model_meta` left out (a random model
    sign)."""
    out = {}
    for root, _, names in os.walk(path):
        for name in names:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, path)
            if name.endswith(".npz"):
                with np.load(full) as z:
                    out[rel] = {k: z[k].tobytes() for k in z.files}
            elif name != "model_meta":
                with open(full, "rb") as f:
                    out[rel] = f.read()
    return out


def mesh_placement_rank(mesh, tmp: str):
    """One rank of the placement run (gloo, its tensors on the card): the
    flagship at 2^22 rows a shard, four configurations of `PLACE_CONFIGS`,
    each through the kernels and again through the plain versions from the
    same state, bit-equal; (b) and (c), after `hot_sync`, against the run
    without placement, bit-equal, and their sharded saves against its
    save. Returns numpy and plain numbers only."""
    import torch
    from openembedding_tpu_torch import data, ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.ops import wire as wire_mod
    from openembedding_tpu_torch.parallel import MeshTrainer, collectives
    from openembedding_tpu_torch.parallel.multihost import local_batch
    from openembedding_tpu_torch.placement import (candidate_weights,
                                                   plan_migration)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S = mesh.size
    check(mesh.staged and S == MESH_STAGED, f"a staged mesh {mesh}")
    globals_ = list(data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED, steps=PLACE_STEPS))
    batches = [local_batch(b, mesh) for b in globals_]
    ids = np.concatenate([b["sparse"]["categorical"].reshape(-1)
                          for b in globals_])
    uniq, cnt = np.unique(ids, return_counts=True)
    order = np.argsort(-cnt, kind="stable")
    hot_ids = uniq[order][:PLACE_HOT].astype(np.int64)
    ranked = list(zip(uniq[order][:PLACE_HOT * 8].tolist(),
                      cnt[order][:PLACE_HOT * 8].astype(float).tolist()))

    def moves_for(hot):
        def moves(stats0):
            cand = candidate_weights(ranked, hot)
            got, own, projected = plan_migration(
                stats0["categorical/shard_positions"], cand, num_shards=S,
                max_moves=PLACE_MIG, target=1.0,
                total=float(ids.size))
            moves.projected = projected
            return got, own
        return moves

    out = {"rank": mesh.rank, "runs": []}
    base = None
    for name, kw in PLACE_CONFIGS.items():
        # a model each
        trainer = MeshTrainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                              optimizers.Adagrad(learning_rate=0.05),
                              mesh=mesh, **kw)
        if base is None:
            # the run without placement, (b) and (c)'s reference
            plain_trainer = MeshTrainer(
                make_deepfm(vocabulary=VOCAB, dim=DIM),
                optimizers.Adagrad(learning_rate=0.05), mesh=mesh,
                wire="fp32")
            base = plain_trainer.init(batches[0])
            base, base_losses, _, _ = place_run(
                torch, plain_trainer, base, batches, None, None)
            plain_trainer.save(base, os.path.join(tmp, "base"))
        state = trainer.init(batches[0])
        ref = state.clone()
        moves = moves_for(hot_ids if trainer.hot_enabled else None)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        staged0 = mesh.staged_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses, stats, made = place_run(torch, trainer, state,
                                               batches, hot_ids, moves)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _mesh_launches(ops.launch_counts())
        staged = mesh.staged_bytes - staged0
        peak = torch.cuda.max_memory_allocated()
        # the steps alone: each again, timed, from a copy (placement
        # changes stay out of the timed steps)
        timed = state.clone()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        staged1 = mesh.staged_bytes
        t1 = time.perf_counter()
        for b in batches:
            timed, _ = trainer.train_step(timed, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / len(batches)
        step_staged = (mesh.staged_bytes - staged1) / len(batches)
        step_launches = _mesh_launches(ops.launch_counts())
        del timed
        # a step's launches name its paths: the owner's serve and apply,
        # the residuals' read (int8 with EF), the hot cache's gather and
        # apply, the annex's serve and apply
        ef, hot, mig = (trainer.ef_for("categorical"), trainer.hot_enabled,
                        trainer.mig_enabled)
        want = {"gather_rows": len(batches) * (1 + ef + hot + mig),
                "gather_rows_windows": 0,
                "fused_sparse_apply": len(batches) * (1 + hot + mig)}
        check(step_launches == want, f"{name}: a step launches the "
              f"kernels of its paths ({step_launches}, want {want})")
        with ops.plain_versions():
            ref, ref_losses, _, _ = place_run(torch, trainer, ref,
                                              batches, hot_ids, moves)
        cmp = _compare(torch, mb, state, losses, ref, ref_losses,
                       "vs_plain")
        del ref
        st = stats[-1]
        dim = DIM + 1
        cap = batches[0]["sparse"]["categorical"].size  # exact buckets
        fmt = trainer.wire_for("categorical")
        rec = {"config": name, "wire": fmt, "hot_wire": kw.get("hot_wire"),
               "ef": ef, "losses": losses.tolist(), "launches": launches,
               "timed_steps_launches": step_launches,
               "ms_per_step": ms, "place_run_seconds": wall,
               "staged_bytes_per_step": step_staged,
               "staged_bytes_place_run": staged,
               "exchange_cost_bytes_per_step": wire_mod.exchange_cost(
                   [{"dim": dim, "cap": cap, "pair": False,
                     "id_itemsize": 8}], S, fmt)["bytes_per_step"],
               "peak_memory_bytes": peak,
               "shard_positions": [s["categorical/shard_positions"].tolist()
                                   for s in stats], **cmp}
        if trainer.hot_enabled:
            hot_fmt = kw.get("hot_wire") or fmt
            rec.update({
                "hot_hit_ratio": [float(s["categorical/hot_hits"])
                                  / float(s["categorical/pull_indices"])
                                  for s in stats],
                "hot_unique": [int(s["categorical/hot_unique"])
                               for s in stats],
                "hot_bytes_saved": [float(s["categorical/hot_bytes_saved"])
                                    for s in stats],
                "hot_reduce_cost_bytes": wire_mod.hot_reduce_cost(
                    [{"dim": dim, "hot": PLACE_HOT}], S, hot_fmt)["bytes"]})
        if trainer.mig_enabled:
            rec.update({
                "moves": int(len(made[0])),
                "imbalance_step0": _imbalance(
                    stats[0]["categorical/shard_positions"]),
                "imbalance_after": [_imbalance(
                    s["categorical/shard_positions"]) for s in stats[1:]],
                "imbalance_projected": moves.projected,
                "mig_unique": [int(s["categorical/mig_unique"])
                               for s in stats],
                "mig_hits": [int(s["categorical/mig_hits"]) for s in stats]})
        if name[0] in "bc":
            # after hot_sync, bit-equal to the run without placement, and
            # so is its sharded save (the save runs hot_sync itself)
            state = trainer.hot_sync(state)
            got, want = _table_bits(torch, mb, state), \
                _table_bits(torch, mb, base)
            unequal = sorted(k for k in want if not torch.equal(
                mb.bits(got[k]), mb.bits(want[k])))
            same_losses = np.array_equal(losses.view(np.int32),
                                         base_losses.view(np.int32))
            check(same_losses and not unequal and got.keys() == want.keys(),
                  f"{name}: after hot_sync equal to the run without "
                  f"placement (losses {same_losses}, unequal {unequal})")
            trainer.save(state, os.path.join(tmp, name[0]))
            same_files = None
            if mesh.rank == 0:
                a = _save_files(os.path.join(tmp, name[0]))
                b = _save_files(os.path.join(tmp, "base"))
                same_files = a.keys() == b.keys() and all(
                    a[k] == b[k] for k in a)
                check(same_files, f"{name}: its save equals the save of "
                      "the run without placement, byte for byte")
                shutil.rmtree(os.path.join(tmp, name[0]), ignore_errors=True)
            collectives.barrier(mesh)
            rec.update(equal_to_no_placement=True,
                       save_byte_identical=same_files)
        for k in ("gather_rows", "fused_sparse_apply"):
            check(launches[k] > 0, f"rank {mesh.rank} ({name}) launched {k}")
        out["runs"].append(rec)
        del trainer, state
        torch.cuda.empty_cache()
    return out


def mesh_placement(torch) -> dict:
    """Four ranks on the one card over gloo: the placement run."""
    from openembedding_tpu_torch.parallel.multihost import run_local
    tmp = tempfile.mkdtemp(prefix="chip_smoke-place-")
    t0 = time.perf_counter()
    try:
        ranks = run_local(mesh_placement_rank, MESH_STAGED, backend="gloo",
                          device="cuda", args=(tmp,), timeout_s=900,
                          threads=0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"run": "mesh4-placement", "ranks": MESH_STAGED,
           "wall_seconds": time.perf_counter() - t0, "per_rank": ranks}
    for name in PLACE_CONFIGS:
        runs = [r["runs"][i] for r in ranks
                for i, run in enumerate(r["runs"]) if run["config"] == name]
        # the stats are summed over the ranks: every rank reports the same
        check(all(run["losses"] == runs[0]["losses"] for run in runs),
              f"{name}: the ranks report one loss")
    return rec


PIPE_K = 4                # K of each pipelined window and its serial twin
# name -> MeshTrainer arguments of the pipelined run
PIPE_CONFIGS = {
    "a fp32": dict(wire="fp32"),
    "b int8+ef": dict(wire="int8"),
    "c int8 hot mig hot_wire int8": dict(
        wire="int8", hot_rows=PLACE_HOT, mig_rows=PLACE_MIG,
        hot_wire="int8"),
}


def _placement_sets(S, batches_global):
    """The hot set (the batches' 1,024 most frequent ids) and the moves
    (the 256 after the first 2,048, each one shard over), the same on
    every rank."""
    ids = np.concatenate([b["sparse"]["categorical"].reshape(-1)
                          for b in batches_global])
    uniq, cnt = np.unique(ids, return_counts=True)
    top = uniq[np.argsort(-cnt, kind="stable")].astype(np.int64)
    mv = top[PLACE_HOT * 2:PLACE_HOT * 2 + PLACE_MIG]
    return top[:PLACE_HOT], (mv, (mv + 1) % S)


def _install(trainer, state, hot, moves):
    if trainer.hot_enabled:
        state = trainer.refresh_hot_rows(state, hot_ids={"categorical": hot})
    if trainer.mig_enabled:
        state = trainer.migrate_rows(state, moves={"categorical": moves})
    return state


def _window(torch, ops, trainer, state, stacked):
    """One `train_many` window, counts set to 0 just before and read just
    after -> (state, metrics, launches, seconds, staged bytes)."""
    mesh = trainer.mesh
    ops.reset_launch_counts()
    staged0 = mesh.staged_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = trainer.train_many(state, stacked)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (state, m, _mesh_launches(ops.launch_counts()), seconds,
            mesh.staged_bytes - staged0)


def mesh_pipelined_rank(mesh):
    """One rank of the pipelined run (gloo, its tensors on the card): the
    flagship at 2^22 rows a shard, each configuration of `PIPE_CONFIGS`
    from one state (its placement installed first) through a serial
    `train_many` window of PIPE_K and a pipelined one, bit-equal; the
    pipelined window again through the plain versions and with its
    prefetch on the side stream, each bit-equal; its extra launches (one
    readonly gather a body step, and the annex's) and staged bytes (two
    copies of `wire.conflict_patch_cost` a body step and the window's
    counters, less one sum of pull stats) checked. Returns numpy and
    plain numbers only."""
    import torch
    from openembedding_tpu_torch import data, ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.ops import wire as wire_mod
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    from openembedding_tpu_torch.parallel.sharded import conflict_patch_cap
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S = mesh.size
    check(mesh.staged and S == MESH_STAGED, f"a staged mesh {mesh}")
    globals_ = list(data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED, steps=PIPE_K))
    stacked = _stacked([local_batch(b, mesh) for b in globals_])
    hot, moves = _placement_sets(S, globals_)
    cap = BATCH // S * FIELDS  # exact buckets
    dim = DIM + 1
    out = {"rank": mesh.rank, "runs": []}
    for name, kw in PIPE_CONFIGS.items():
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)
        serial = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                             mesh=mesh, **kw)
        piped = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                            mesh=mesh, pipeline_steps=True, **kw)
        state = _install(serial, serial.init(local_batch(globals_[0], mesh)),
                         hot, moves)
        ref, plain, side = state.clone(), state.clone(), state.clone()
        if not out["runs"]:
            # a process's first window pays its setup (cuBLAS, the first
            # collectives): one untimed window first
            serial.train_many(state.clone(), stacked)
        ref, rm, s_launches, s_sec, s_staged = _window(
            torch, ops, serial, ref, stacked)
        state, pm, p_launches, p_sec, p_staged = _window(
            torch, ops, piped, state, stacked)
        losses = pm["loss"].float().cpu().numpy()
        cmp = _compare(torch, mb, state, losses, ref,
                       rm["loss"].float().cpu().numpy(), "pipelined_vs_serial")
        with ops.plain_versions():
            plain, plm = piped.train_many(plain, stacked)
        cmp.update(_compare(torch, mb, state, losses, plain,
                            plm["loss"].float().cpu().numpy(), "vs_plain"))
        # the prefetch's side stream, which only NCCL across cards runs,
        # forced on this staged mesh: the same window, bit-equal
        piped._side = torch.cuda.Stream(mesh.device)
        piped._prefetch_stream = lambda: piped._side
        side, sm = piped.train_many(side, stacked)
        cmp.update(_compare(torch, mb, state, losses, side,
                            sm["loss"].float().cpu().numpy(), "side_stream"))
        del ref, plain, side
        conflict = int(pm["conflict"]["categorical"])
        check(conflict > 0 and int(pm["conflict_overflow"]) == 0,
              f"{name}: the patch repaired rows, none past the cap "
              f"({conflict}, {int(pm['conflict_overflow'])})")
        check(sorted(rm) == ["loss", "overflow"] and sorted(pm) == [
            "conflict", "conflict_overflow", "loss", "overflow"],
            f"{name}: the windows' metrics ({sorted(rm)}, {sorted(pm)})")
        # the patch's launches: a readonly gather a body step, and the
        # annex's where the table has one
        mig = piped.mig_enabled
        want = {"gather_rows": s_launches["gather_rows"]
                + (PIPE_K - 1) * (1 + mig),
                "gather_rows_windows": 0,
                "fused_sparse_apply": s_launches["fused_sparse_apply"]}
        check(p_launches == want, f"{name}: the pipelined window launches "
              f"the serial one's kernels and the patch's ({p_launches}, "
              f"want {want})")
        fmt = piped.wire_for("categorical")
        patch = wire_mod.conflict_patch_cost(
            [{"dim": dim, "cap": cap,
              "pcap": conflict_patch_cap(cap, piped.conflict_factor)}],
            S, fmt)["bytes_patch"]
        # each patch's all_to_all staged to the host and back, and the
        # window's counters summed once (an int32 vector all_gathered);
        # less one sum of pull stats (float64 values: 3 counts, 3 vectors
        # of S, 3 hot and 2 annex stats): the window keeps only the
        # overflow of its first batch's, as the JAX window does
        counters = 4 * 3 * (1 + S)
        n_pull = 3 + 3 * S + 3 * piped.hot_enabled + 2 * mig
        want_extra = (2 * (PIPE_K - 1) * patch + counters
                      - 8 * n_pull * (1 + S))
        extra = p_staged - s_staged
        check(extra == want_extra,
              f"{name}: the pipelined window stages the serial one's bytes "
              f"and the patch's ({extra} extra, want {want_extra})")
        exchange = wire_mod.exchange_cost(
            [{"dim": dim, "cap": cap, "pair": False, "id_itemsize": 8}],
            S, fmt)["bytes_per_step"]
        out["runs"].append({
            "config": name, "wire": fmt, "losses": losses.tolist(),
            "conflict_rows": conflict,
            "conflict_overflow": int(pm["conflict_overflow"]),
            "serial_launches": s_launches, "launches": p_launches,
            "serial_ms_per_step": s_sec * 1e3 / PIPE_K,
            "ms_per_step": p_sec * 1e3 / PIPE_K,
            "serial_staged_bytes_per_step": s_staged / PIPE_K,
            "staged_bytes_per_step": p_staged / PIPE_K,
            "exchange_cost_bytes_per_step": exchange,
            "conflict_patch_cost_bytes": patch, **cmp})
        del serial, piped, state
        torch.cuda.empty_cache()
    return out


def mesh_pipelined(torch) -> dict:
    """Four ranks on the one card over gloo: the pipelined run."""
    from openembedding_tpu_torch.parallel.multihost import run_local
    t0 = time.perf_counter()
    ranks = run_local(mesh_pipelined_rank, MESH_STAGED, backend="gloo",
                      device="cuda", timeout_s=600, threads=0)
    rec = {"run": "mesh4-pipelined", "ranks": MESH_STAGED, "k": PIPE_K,
           "wall_seconds": time.perf_counter() - t0, "per_rank": ranks}
    for i, name in enumerate(PIPE_CONFIGS):
        runs = [r["runs"][i] for r in ranks]
        check(all(run["losses"] == runs[0]["losses"]
                  and run["conflict_rows"] == runs[0]["conflict_rows"]
                  for run in runs),
              f"{name}: the ranks report one loss and one conflict count")
    return rec


ZERO_STEPS = 4            # eager steps of each ZeRO configuration
ZERO_K = 4                # K of the pipelined ZeRO window and its serial twin
# name -> MeshTrainer arguments of the ZeRO run (`case_zero`'s Adam)
ZERO_CONFIGS = {
    "r replicated": {},
    "a fp32": dict(dense_shard=True),
    "b bf16": dict(dense_shard=True, dense_wire="bf16"),
    "c int8": dict(dense_shard=True, dense_wire="int8"),
    "d sparse_topk": dict(dense_shard=True, dense_wire="sparse_topk"),
}


def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _dense_slot_bytes(state, zero) -> dict:
    """A rank's measured bytes of its dense optimizer state: the per-leaf
    slots, or the flat form's slots, masters and residual apart (the keys
    of `zero.plan_device_bytes`)."""
    if not zero.is_sharded_slots(state.dense_slots):
        return {"replicated_slots": _tensor_bytes(state.dense_slots)}
    flat = state.dense_slots[zero.ZERO_KEY]
    extra = {zero.DENSE_EF_KEY: "zero_ef", zero.DENSE_MASTER_KEY:
             "zero_master"}
    out = {"zero_slots": sum(_tensor_bytes(v) for k, v in flat.items()
                             if k not in extra)}
    out.update({name: _tensor_bytes(flat[k]) for k, name in extra.items()
                if k in flat})
    return out


def mesh_zero_rank(mesh, tmp: str):
    """One rank of the ZeRO run (gloo, its tensors on the card): the
    flagship at 2^22 rows a shard and `case_zero`'s Adam(0.001), each
    configuration of `ZERO_CONFIGS` for ZERO_STEPS eager steps from its
    init, bit-equal to the same steps through the plain versions; (a)
    against (r) bit for bit (losses and the externalized state) and their
    sharded saves byte-identical; `set_dense_wire` from (a) to int8 and
    back, the externalized state unchanged; (c) and (d) saved and loaded
    into a trainer without ZeRO (equal to what was saved, one step) and
    into one of their own (the residual zero); the pipelined window of
    ZERO_K with (a) bit-equal to the serial one, and to itself with its
    prefetch forced onto the side stream. Each configuration's
    staged bytes a step are (r)'s less the replicated dense sum's plus
    its own dense collectives', from `zero.dense_wire_cost`, exactly, and
    its dense optimizer-state bytes `zero.plan_device_bytes`. Returns
    numpy and plain numbers only."""
    import torch
    from openembedding_tpu_torch import data, ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer, zero
    from openembedding_tpu_torch.parallel.collectives import barrier
    from openembedding_tpu_torch.parallel.multihost import local_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S = mesh.size
    check(mesh.staged and S == MESH_STAGED, f"a staged mesh {mesh}")
    globals_ = list(data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED, steps=ZERO_STEPS))
    batches = [local_batch(b, mesh) for b in globals_]

    def trainer_of(**kw):
        return MeshTrainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                           optimizers.Adam(learning_rate=0.001), mesh=mesh,
                           wire="fp32", **kw)

    out = {"rank": mesh.rank, "runs": []}
    ref = {}
    for name, kw in ZERO_CONFIGS.items():
        trainer = trainer_of(**kw)
        state = trainer.init(batches[0])
        slot_bytes = _dense_slot_bytes(state, zero)
        if not out["runs"]:
            # a process's first step pays its setup (cuBLAS, the first
            # collectives): one untimed step first
            trainer.train_step(state.clone(), batches[0])
        state, losses, launches, ms, staged, cmp = _staged_run(
            torch, mb, ops, trainer, state, batches)
        check(np.isfinite(losses).all(), f"{name}: finite losses")
        rec = {"config": name, "losses": losses.tolist(),
               "launches": launches, "ms_per_step": ms,
               "staged_bytes_per_step": staged,
               "dense_slot_bytes": slot_bytes, **cmp}
        if trainer.zero_enabled:
            plan = trainer._zero_plan
            k = (trainer.dense_topk_for(plan)
                 if trainer.dense_wire == "sparse_topk" else None)
            want = zero.plan_device_bytes(
                plan, ef=trainer.dense_ef_enabled,
                master=bool(trainer.dense_wire))
            check(slot_bytes == want, f"{name}: a rank's dense optimizer "
                  f"state is plan_device_bytes ({slot_bytes}, {want})")
            rec.update(plan_total=plan.total, plan_chunk=plan.chunk,
                       plan_padded=plan.padded, topk=k,
                       plan_device_bytes=want,
                       dense_wire_cost=zero.dense_wire_cost(
                           plan, trainer.dense_wire, topk=k))
        else:
            plan = zero.build_plan(zero.trainable_leaves(
                state.dense, state.embeddings), trainer.optimizer, S)
            rec.update(plan_total=plan.total)
        if name[0] in "ra":
            ref[name[0]] = (trainer, state, losses)
        if name[0] in "cd":
            rec.update(_zero_reload(torch, mb, trainer, state, trainer_of,
                                    batches, os.path.join(tmp, name[0]),
                                    zero, kw))
        if name[0] == "a":
            rec.update(_zero_against_replicated(
                torch, mb, ref, os.path.join(tmp, "saves"), S))
            rec.update(_zero_switch(torch, mb, trainer, state))
            del ref["r"]
        out["runs"].append(rec)
        del trainer, state
        torch.cuda.empty_cache()
    ref.clear()
    serial, piped = trainer_of(**ZERO_CONFIGS["a fp32"]), trainer_of(
        pipeline_steps=True, **ZERO_CONFIGS["a fp32"])
    wb = [local_batch(b, mesh) for b in data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED + 1, steps=ZERO_K)]
    stacked = _stacked(wb)
    state = serial.init(wb[0])
    twin, side = state.clone(), state.clone()
    twin, sm, s_launches, s_sec, _ = _window(torch, ops, serial, twin,
                                             stacked)
    state, pm, p_launches, p_sec, _ = _window(torch, ops, piped, state,
                                              stacked)
    losses = pm["loss"].float().cpu().numpy()
    cmp = _compare(torch, mb, state, losses, twin,
                   sm["loss"].float().cpu().numpy(),
                   "zero_pipelined_vs_serial")
    # the prefetch's side stream, which only NCCL across cards runs,
    # forced on this staged mesh beside the dense collectives on the main
    # stream: the same window, bit-equal
    piped._side = torch.cuda.Stream(mesh.device)
    piped._prefetch_stream = lambda: piped._side
    side, sdm = piped.train_many(side, stacked)
    cmp.update(_compare(torch, mb, state, losses, side,
                        sdm["loss"].float().cpu().numpy(),
                        "zero_side_stream"))
    del twin, side
    check(int(pm["conflict"]["categorical"]) > 0,
          "the pipelined ZeRO window patched rows")
    out["pipelined"] = {"k": ZERO_K, "serial_launches": s_launches,
                        "launches": p_launches,
                        "serial_ms_per_step": s_sec * 1e3 / ZERO_K,
                        "ms_per_step": p_sec * 1e3 / ZERO_K, **cmp}
    barrier(mesh)
    return out


def _zero_against_replicated(torch, mb, ref, tmp, S) -> dict:
    """(a) against (r): losses and the externalized state bit-equal, the
    sharded saves byte-identical (rank 0 compares the files, an .npz by
    its arrays' bytes; the save returns once every rank has written)."""
    (tr_r, st_r, l_r), (tr_a, st_a, l_a) = ref["r"], ref["a"]
    out = _compare(torch, mb, tr_a.externalize(st_a), l_a,
                   tr_r.externalize(st_r), l_r, "zero_vs_replicated")
    paths = [os.path.join(tmp, t) for t in ("r", "a")]
    tr_r.save(st_r, paths[0])
    tr_a.save(st_a, paths[1])
    if tr_a.mesh.rank == 0:
        files = [_save_files(p) for p in paths]
        check(files[0] == files[1] and bool(files[0]),
              "the ZeRO save is byte-identical to the replicated one")
        out["save_files_compared"] = len(files[0])
        del files
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _zero_switch(torch, mb, trainer, state) -> dict:
    """`set_dense_wire` from fp32 to int8 and back, in place: the
    externalized state bit-equal throughout (the masters are the params
    at the switch), the residual zero after it."""
    from openembedding_tpu_torch.parallel import zero
    before = trainer.externalize(state)
    zeros = np.zeros(1, np.float32)
    epoch = trainer.graph_epoch
    check(trainer.set_dense_wire(state, "int8") is state,
          "set_dense_wire works in place")
    flat = state.dense_slots[zero.ZERO_KEY]
    check(not bool(flat[zero.DENSE_EF_KEY].any()),
          "the int8 residual starts at zero")
    out = _compare(torch, mb, trainer.externalize(state), zeros, before,
                   zeros, "switch_to_int8")
    trainer.set_dense_wire(state, None)
    check(trainer.graph_epoch == epoch + 2
          and sorted(state.dense_slots[zero.ZERO_KEY]) == sorted(
              trainer.optimizer.slot_shapes(1)),
          "two switches, and the fp32 flat slots back")
    out.update(_compare(torch, mb, trainer.externalize(state), zeros,
                        before, zeros, "switch_round_trip"))
    return out


def _zero_reload(torch, mb, trainer, state, trainer_of, batches, path,
                 zero, kw) -> dict:
    """A dense wire's state saved, then loaded into a trainer without ZeRO
    (equal to the saved one externalized, then one step) and into one of
    its own format (equal again, the residual zero)."""
    from openembedding_tpu_torch.parallel.collectives import barrier
    saved = trainer.externalize(state)
    trainer.save(state, path)
    zeros = np.zeros(1, np.float32)
    out = {}
    for tag, args in (("replicated", {}), ("own", kw)):
        other = trainer_of(**args)
        st = other.load(other.init(batches[0]), path)
        out.update(_compare(torch, mb, other.externalize(st), zeros, saved,
                            zeros, f"reload_{tag}"))
        if tag == "own":
            check(not bool(st.dense_slots[zero.ZERO_KEY][
                zero.DENSE_EF_KEY].any()), "a loaded residual is zero")
        else:
            st, m = other.train_step(st, batches[0])
            out["reload_replicated_loss"] = float(m["loss"])
            check(np.isfinite(out["reload_replicated_loss"]),
                  "a step after the load")
        del other, st
    barrier(trainer.mesh)  # every rank has loaded
    if trainer.mesh.rank == 0:
        shutil.rmtree(path, ignore_errors=True)
    return out


def mesh_zero(torch) -> dict:
    """Four ranks on the one card over gloo: the ZeRO run."""
    from openembedding_tpu_torch.parallel.multihost import run_local
    tmp = tempfile.mkdtemp(prefix="chip_smoke-zero-")
    t0 = time.perf_counter()
    try:
        ranks = run_local(mesh_zero_rank, MESH_STAGED, backend="gloo",
                          device="cuda", args=(tmp,), timeout_s=900,
                          threads=0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"run": "mesh4-zero", "ranks": MESH_STAGED, "steps": ZERO_STEPS,
           "wall_seconds": time.perf_counter() - t0, "per_rank": ranks}
    S = MESH_STAGED
    for i, name in enumerate(ZERO_CONFIGS):
        runs = [r["runs"][i] for r in ranks]
        check(all(run["losses"] == runs[0]["losses"] for run in runs),
              f"{name}: the ranks report one loss")
        for r, run in zip(ranks, runs):
            for k in ("gather_rows", "fused_sparse_apply"):
                check(run["launches"][k] > 0,
                      f"rank {r['rank']} ({name}) launched {k}")
    for r in ranks:
        base = r["runs"][0]
        rep_bytes = base["dense_slot_bytes"]["replicated_slots"]
        for run in r["runs"][1:]:
            # the staged bytes: (r)'s, less its dense sum (an all_gather of
            # the float32 gradients: total * 4 out, S times that in), plus
            # this configuration's collectives: the reduce_scatter's or the
            # encoded all_to_all's buffer out and in, and the params'
            # all_gather (a chunk out, the whole vector in)
            cost = run["dense_wire_cost"]
            want = (base["staged_bytes_per_step"]
                    - (1 + S) * 4 * base["plan_total"]
                    + 2 * (cost["rs_bytes"] + cost["a2a_bytes"])
                    + cost["ag_bytes"] + cost["ag_bytes"] // S)
            run["staged_bytes_vs_replicated"] = (
                run["staged_bytes_per_step"] - base["staged_bytes_per_step"])
            check(run["staged_bytes_per_step"] == want,
                  f"{run['config']}: staged bytes a step "
                  f"{run['staged_bytes_per_step']} are the replicated run's "
                  f"{base['staged_bytes_per_step']} less its dense sum plus "
                  f"the dense wire's ({want})")
            run["dense_slot_bytes_cut"] = (
                rep_bytes / run["dense_slot_bytes"]["zero_slots"])
        a = r["runs"][1]
        check(a["dense_slot_bytes_cut"] > 0.9 * S,
              f"ZeRO holds about 1/{S} of the replicated dense optimizer "
              f"state ({a['dense_slot_bytes_cut']})")
    return rec


def mesh_entry(torch, mb, ops, tsv: str) -> dict:
    """The entry point's `--mesh` at one rank on the seeded TSV: a graph
    run saved after one pass, then loaded and run 16 steps more, held to
    one uninterrupted run through the plain versions."""
    import torch.distributed as dist
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    tmp = tempfile.mkdtemp(prefix="chip_smoke-mesh-")
    try:
        ckpt = os.path.join(tmp, "ckpt")
        base = ["--mesh", "--data", tsv, "--vocabulary", str(VOCAB),
                "--dim", str(DIM), "--batch-size", str(BATCH)]
        saved, l1 = _run_main(ops, ex, base + [
            "--steps", str(MESH_ENTRY_SAVE), "--save", ckpt])
        check(sorted(os.listdir(os.path.join(ckpt, "variable_0")))
              == ["shard_00000_of_00001"], "a sharded checkpoint")
        loaded, l2 = _run_main(ops, ex, base + [
            "--steps", str(MESH_ENTRY_STEPS), "--load", ckpt])
        total = MESH_ENTRY_SAVE + MESH_ENTRY_STEPS
        with ops.plain_versions():
            plain = ex.main(base + ["--steps", str(total), "--eager"])
        launches = {k: l1[k] + l2[k] for k in KERNELS}
        check(launches["gather_rows_windows"] == 0
              and launches["gather_rows"] == total + 2
              and launches["fused_sparse_apply"] == total,
              f"--mesh: one gather a step (and one at each init), one "
              f"apply a step ({launches})")
        rec = {"run": "entry --mesh", "steps": total, "launches": launches,
               "saved_graph": saved["graph"], "loaded_graph": loaded["graph"],
               "steady_ms_per_step": loaded["steady_seconds"] * 1e3
               / max(loaded["steady_steps"], 1)}
        both = np.concatenate([saved["losses"], loaded["losses"]])
        rec.update(_compare(torch, mb, loaded["state"], both,
                            plain["state"], plain["losses"],
                            "save_load_vs_plain"))
        return rec
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_nccl_rank(mesh, steps):
    """One rank of the NCCL run across cards: eager steps against the same
    steps through `jit_train_step`, bit-equal."""
    import torch
    from openembedding_tpu_torch import data, ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    batches = [local_batch(b, mesh) for b in data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED, steps=steps)]
    trainer = MeshTrainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                          optimizers.Adagrad(learning_rate=0.05), mesh=mesh)
    state = trainer.init(batches[0])
    graph_state = state.clone()
    # step 0 apart: NCCL sets its communicators up at the first collective
    state, first, launches, _, _, cmp = _staged_run(
        torch, mb, ops, trainer, state, batches[:1])
    state, more, more_launches, ms, _, cmp2 = _staged_run(
        torch, mb, ops, trainer, state, batches[1:])
    losses = np.concatenate([first, more])
    launches = {k: launches[k] + more_launches[k] for k in launches}
    cmp.update({k + "_later": v for k, v in cmp2.items()})
    step = trainer.jit_train_step()
    ops.reset_launch_counts()
    graph_losses = []
    for i, b in enumerate(batches):
        if i == 1:  # after the capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        graph_state, m = step(graph_state, b)
        graph_losses.append(m["loss"].clone())
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    graph = graph_record(step)
    ran = ran_launches(ops.launch_counts(), [graph])
    cmp.update(_compare(torch, mb, graph_state,
                        torch.stack(graph_losses).cpu().numpy(), state,
                        losses, "graph_vs_eager"))
    placed = nccl_placement(torch, mb, ops, mesh, batches)
    piped = nccl_pipelined(torch, mb, ops, mesh, batches)
    zeroed = nccl_zero(torch, mb, ops, mesh, batches)
    for k in KERNELS:
        launches[k] += placed["launches"][k] + sum(
            piped["eager_launches"][n][k] for n in piped["eager_launches"]) \
            + zeroed["launches"][k]
        ran[k] += placed["graph_launches"][k] + sum(
            piped["graph_launches"][n][k] for n in piped["graph_launches"]) \
            + zeroed["graph_launches"][k]
    return {"rank": mesh.rank, "eager_ms_per_step": ms,
            "graph_ms_per_step": graph_ms, "launches": launches,
            "graph_launches": ran, "placement": placed,
            "pipelined": piped, "zero": zeroed, **cmp}


def nccl_placement(torch, mb, ops, mesh, batches) -> dict:
    """Configuration (d) of the placement run (int8 wire with residuals,
    hot rows, migration, the int8 hot reduce) over NCCL: eager steps, then
    the same steps through `jit_train_step`, with a hot set installed
    before step 0, moves before step 2 and another hot set before step 3.
    The placement writes into the captured tensors, so the step captures
    once; bit-equal to eager."""
    from openembedding_tpu_torch import data, optimizers
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    S = mesh.size
    # the sets from the global batches: every rank installs the same
    ids = np.concatenate([b["sparse"]["categorical"].reshape(-1)
                          for b in data.synthetic_criteo(
                              BATCH, id_space=VOCAB, seed=TRAIN_SEED,
                              steps=len(batches))])
    uniq, cnt = np.unique(ids, return_counts=True)
    top = uniq[np.argsort(-cnt, kind="stable")].astype(np.int64)
    hot = {0: top[:PLACE_HOT], 3: top[PLACE_HOT // 2:PLACE_HOT * 3 // 2]}
    mv = top[PLACE_HOT * 2:PLACE_HOT * 2 + PLACE_MIG]
    moves = {2: (mv, (mv + 1) % S)}
    trainer = MeshTrainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                          optimizers.Adagrad(learning_rate=0.05), mesh=mesh,
                          **PLACE_CONFIGS["d int8 hot mig hot_wire int8"])
    state = trainer.init(batches[0])
    graph_state = state.clone()

    def run(st, step):
        losses = []
        for k, b in enumerate(batches):
            if k in hot:
                st = trainer.refresh_hot_rows(st,
                                              hot_ids={"categorical": hot[k]})
            if k in moves:
                st = trainer.migrate_rows(st,
                                          moves={"categorical": moves[k]})
            st, m = step(st, b)
            losses.append(m["loss"].clone())
        return st, torch.stack(losses).cpu().numpy()

    ops.reset_launch_counts()
    state, losses = run(state, trainer.train_step)
    launches = _mesh_launches(ops.launch_counts())
    step = trainer.jit_train_step()
    ops.reset_launch_counts()
    graph_state, graph_losses = run(graph_state, step)
    graph = graph_record(step)
    ran = ran_launches(_mesh_launches(ops.launch_counts()), [graph])
    cmp = _compare(torch, mb, graph_state, graph_losses, state, losses,
                   "placement_graph_vs_eager")
    auto = nccl_controller(torch, mb, ops, mesh)
    for k in KERNELS:
        launches[k] += auto["launches"][k]
        ran[k] += auto["graph_launches"][k]
    return {"steps": len(batches), "launches": launches,
            "graph_launches": ran, "graph": graph, "controller": auto,
            **cmp}


NCCL_AUTO_STEPS = 6       # steps a phase of the controller's drift over NCCL


def nccl_controller(torch, mb, ops, mesh) -> dict:
    """The placement controller over NCCL across cards: the drift stream
    (`drift_stream`, 6 steps a phase), `prime`, then the steps through
    `jit_train_step` with `on_step` after each (rank 0's decisions sent to
    every rank): one capture, every refresh and migration written into the
    captured tensors; bit-equal to the same steps eager."""
    from openembedding_tpu_torch import optimizers
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    from openembedding_tpu_torch.utils import metrics as M
    from openembedding_tpu_torch.utils.sketch import SkewMonitor
    globals_ = drift_stream(mesh.size, NCCL_AUTO_STEPS)
    ids = [b["sparse"]["categorical"] for b in globals_]
    batches = [local_batch(b, mesh) for b in globals_]

    def trainer_of():
        return MeshTrainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                           optimizers.Adagrad(learning_rate=0.05),
                           mesh=mesh)
    trainer = trainer_of()
    start = trainer.init(batches[0])

    def run(tr, st, graph: bool):
        with M._LOCK:   # each run reads its own shard loads
            M._REGISTRY.clear()
        mon = SkewMonitor(k=256, sync=True, decay=0.9)
        ctrl = _auto_controller(tr, mon, ids)
        st = ctrl.prime(st)
        step = tr.jit_train_step() if graph else tr.train_step
        losses = []
        for i, b in enumerate(batches):
            mon.observe("categorical", ids[i])
            st, m = step(st, b)
            losses.append(m["loss"].clone())
            tr.record_step_stats(m)
            st = ctrl.on_step(st, step=i + 1)
        return st, torch.stack(losses).cpu().numpy(), ctrl.status(), step

    eager_state, eager_losses, eager_status, _ = run(
        trainer_of(), start.clone(), False)
    ops.reset_launch_counts()
    state, losses, status, step = run(trainer, start, True)
    graph = graph_record(step)
    ran = ran_launches(_mesh_launches(ops.launch_counts()), [graph])
    check(status == eager_status and status["migrations_applied"] >= 1,
          f"(nccl controller) the graph run made the eager run's decisions "
          f"({status})")
    cmp = _compare(torch, mb, state, losses, eager_state, eager_losses,
                   "controller_graph_vs_eager")
    return {"steps": len(batches), "status": status, "graph": graph,
            "launches": {k: 0 for k in KERNELS}, "graph_launches": ran,
            **cmp}


NCCL_PIPE_WINDOWS = 6     # windows per jit_train_many; the first captures


def nccl_pipelined(torch, mb, ops, mesh, batches) -> dict:
    """The pipelined fp32 window over NCCL across cards (the prefetch on
    the trainer's side stream): eager, serial and pipelined, from one
    state, bit-equal; then both through `jit_train_many`, each captured
    once and bit-equal to eager after its first replay; then ms a step of
    each graph over its remaining windows."""
    from openembedding_tpu_torch import optimizers
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    model = make_deepfm(vocabulary=VOCAB, dim=DIM)
    trainers = {"serial": MeshTrainer(
        model, optimizers.Adagrad(learning_rate=0.05), mesh=mesh,
        wire="fp32"), "pipelined": MeshTrainer(
        model, optimizers.Adagrad(learning_rate=0.05), mesh=mesh,
        wire="fp32", pipeline_steps=True)}
    stacked = _stacked(batches)
    start = trainers["serial"].init(batches[0])
    eager, launches, out = {}, {}, {}
    for name, tr in trainers.items():
        st = start.clone()
        ops.reset_launch_counts()
        losses = []
        for _ in range(2):
            st, m = tr.train_many(st, stacked)
            losses.append(m["loss"].float().clone())
        launches[name] = _mesh_launches(ops.launch_counts())
        eager[name] = (st, torch.cat(losses).cpu().numpy())
        if name == "pipelined":
            out["conflict_rows"] = int(m["conflict"]["categorical"])
            check(out["conflict_rows"] > 0, "the NCCL window patched rows")
    out.update(_compare(torch, mb, eager["pipelined"][0],
                        eager["pipelined"][1], eager["serial"][0],
                        eager["serial"][1], "nccl_pipelined_vs_serial"))
    ran = {}
    for name, tr in trainers.items():
        # the same start; the graph's first call is its warm-up window
        # and capture, the second its first replay
        st = start.clone()
        many = tr.jit_train_many()
        ops.reset_launch_counts()
        losses = []
        for w in range(NCCL_PIPE_WINDOWS):
            if w == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            st, m = many(st, stacked)
            if w < 2:
                losses.append(m["loss"].float().clone())
            if w == 1:
                out.update(_compare(
                    torch, mb, st, torch.cat(losses).cpu().numpy(),
                    eager[name][0], eager[name][1],
                    f"nccl_{name}_graph_vs_eager"))
        torch.cuda.synchronize()
        out[f"{name}_graph_ms_per_step"] = (
            (time.perf_counter() - t0) * 1e3
            / ((NCCL_PIPE_WINDOWS - 2) * PIPE_K))
        rec = graph_record(many)
        ran[name] = ran_launches(_mesh_launches(ops.launch_counts()), [rec])
        out[f"{name}_graph"] = rec
        del st, many
    del start
    out["eager_launches"] = launches
    out["graph_launches"] = ran
    return out


def nccl_zero(torch, mb, ops, mesh, batches) -> dict:
    """ZeRO over NCCL across cards: (a) fp32 through `jit_train_step`,
    captured once and bit-equal to eager; then `set_dense_wire` to int8 on
    the graph's state, which makes the step capture exactly once more;
    (c) int8 and (d) sparse_topk (its stable sort captured) through
    `jit_train_many` (two windows of the batches, one capture each),
    bit-equal to eager windows; (a) pipelined (`pipeline_steps=True`, the
    prefetch's collectives on the side stream beside the dense ones on
    the main stream): two eager windows bit-equal to the serial ones,
    then through `jit_train_many`, captured once and bit-equal."""
    from openembedding_tpu_torch import optimizers
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer

    def trainer_of(**kw):
        return MeshTrainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                           optimizers.Adam(learning_rate=0.001), mesh=mesh,
                           wire="fp32", **kw)

    out, launches, ran = {}, {k: 0 for k in KERNELS}, {k: 0
                                                      for k in KERNELS}
    tr = trainer_of(**ZERO_CONFIGS["a fp32"])
    state = tr.init(batches[0])
    graph_state = state.clone()
    ops.reset_launch_counts()
    losses = []
    for b in batches:
        state, m = tr.train_step(state, b)
        losses.append(m["loss"].clone())
    counted = _mesh_launches(ops.launch_counts())
    step = tr.jit_train_step()
    ops.reset_launch_counts()
    graph_losses = []
    for b in batches:
        graph_state, m = step(graph_state, b)
        graph_losses.append(m["loss"].clone())
    rec = graph_record(step)
    got = ran_launches(_mesh_launches(ops.launch_counts()), [rec])
    out.update(_compare(torch, mb, graph_state,
                        torch.stack(graph_losses).cpu().numpy(), state,
                        torch.stack(losses).cpu().numpy(),
                        "nccl_zero_graph_vs_eager"))
    tr.set_dense_wire(graph_state, "int8")
    ops.reset_launch_counts()
    for b in batches[:2]:
        graph_state, m = step(graph_state, b)
    check(step.captures == 2 and step.replays == len(batches),
          f"set_dense_wire made the step capture once more ({step.captures}"
          f" captures, {step.replays} replays)")
    check(bool(torch.isfinite(m["loss"])), "a finite int8 loss")
    after = graph_record(step)
    out["switch_graph"] = after
    counted2 = _mesh_launches(ops.launch_counts())
    for k in KERNELS:
        launches[k] += counted[k]
        # the switch's two calls: a warm-up step and a capture, which runs
        # nothing, then a replay
        ran[k] += got[k] + counted2[k] - (
            after["launches_captured"].get(k, 0)
            - rec["launches_captured"].get(k, 0)) + (
            after["launches_replayed"].get(k, 0)
            - rec["launches_replayed"].get(k, 0))
    del tr, state, graph_state, step
    for name in ("c int8", "d sparse_topk"):
        tr = trainer_of(**ZERO_CONFIGS[name])
        stacked = _stacked(batches)
        state = tr.init(batches[0])
        graph_state = state.clone()
        ops.reset_launch_counts()
        losses = []
        for _ in range(2):
            state, m = tr.train_many(state, stacked)
            losses.append(m["loss"].float().clone())
        counted = _mesh_launches(ops.launch_counts())
        many = tr.jit_train_many()
        ops.reset_launch_counts()
        graph_losses = []
        for _ in range(2):
            graph_state, m = many(graph_state, stacked)
            graph_losses.append(m["loss"].float().clone())
        rec = graph_record(many)
        got = ran_launches(_mesh_launches(ops.launch_counts()), [rec])
        tag = name.split()[1]
        out.update(_compare(torch, mb, graph_state,
                            torch.cat(graph_losses).cpu().numpy(), state,
                            torch.cat(losses).cpu().numpy(),
                            f"nccl_zero_{tag}_graph_vs_eager"))
        out[f"{tag}_graph"] = rec
        for k in KERNELS:
            launches[k] += counted[k]
            ran[k] += got[k]
        del tr, state, graph_state, many
    stacked = _stacked(batches)
    trainers = {"serial": trainer_of(**ZERO_CONFIGS["a fp32"]),
                "pipelined": trainer_of(pipeline_steps=True,
                                        **ZERO_CONFIGS["a fp32"])}
    start = trainers["serial"].init(batches[0])
    eager = {}
    ops.reset_launch_counts()
    for name, tr in trainers.items():
        st, losses = start.clone(), []
        for _ in range(2):
            st, m = tr.train_many(st, stacked)
            losses.append(m["loss"].float().clone())
        eager[name] = (st, torch.cat(losses).cpu().numpy())
    counted = _mesh_launches(ops.launch_counts())
    out.update(_compare(torch, mb, *eager["pipelined"], *eager["serial"],
                        "nccl_zero_pipelined_vs_serial"))
    many = trainers["pipelined"].jit_train_many()
    st, graph_losses = start.clone(), []
    ops.reset_launch_counts()
    for _ in range(2):
        st, m = many(st, stacked)
        graph_losses.append(m["loss"].float().clone())
    rec = graph_record(many)
    got = ran_launches(_mesh_launches(ops.launch_counts()), [rec])
    out.update(_compare(torch, mb, st, torch.cat(graph_losses).cpu().numpy(),
                        *eager["pipelined"],
                        "nccl_zero_pipelined_graph_vs_eager"))
    out["pipelined_graph"] = rec
    for k in KERNELS:
        launches[k] += counted[k]
        ran[k] += got[k]
    del trainers, start, eager, st, many
    out["launches"], out["graph_launches"] = launches, ran
    return out


def phase_mesh(torch, mb, ops, data, optimizers, tsv: str,
               array_graph: dict) -> dict:
    """The mesh path (`openembedding_tpu_torch.parallel`): mesh1, the staged
    four-rank runs (plain, placement, pipelined, ZeRO), the entry point's
    --mesh, and NCCL across cards where the machine has them -> {kernel:
    launches of the phase}."""
    t0 = time.perf_counter()
    one = mesh_one(torch, mb, ops, data, optimizers, array_graph)
    emit({"phase": "mesh", **one})
    torch.cuda.empty_cache()
    staged = mesh_staged(torch, optimizers, data)
    emit({"phase": "mesh", **staged})
    torch.cuda.empty_cache()
    placement = mesh_placement(torch)
    emit({"phase": "mesh", **placement})
    torch.cuda.empty_cache()
    pipelined = mesh_pipelined(torch)
    emit({"phase": "mesh", **pipelined})
    torch.cuda.empty_cache()
    zeroed = mesh_zero(torch)
    emit({"phase": "mesh", **zeroed})
    torch.cuda.empty_cache()
    entry = mesh_entry(torch, mb, ops, tsv)
    emit({"phase": "mesh", **entry})
    torch.cuda.empty_cache()
    launches = {k: one["launches"][k] + one["graph_launches"][k]
                + entry["launches"][k] for k in KERNELS}
    for rank in staged["per_rank"]:
        for k in KERNELS:
            launches[k] += rank["launches"][k]
    for rank in placement["per_rank"]:
        for run in rank["runs"]:
            for k in KERNELS:
                launches[k] += run["launches"][k]
    for rank in pipelined["per_rank"]:
        for run in rank["runs"]:
            for k in KERNELS:
                launches[k] += run["serial_launches"][k] + run["launches"][k]
    for rank in zeroed["per_rank"]:
        for k in KERNELS:
            launches[k] += sum(run["launches"][k] for run in rank["runs"]) \
                + rank["pipelined"]["serial_launches"][k] \
                + rank["pipelined"]["launches"][k]
    cards = torch.cuda.device_count()
    if cards >= 2:
        from openembedding_tpu_torch.parallel.multihost import run_local
        S = min(4, cards)
        nccl = run_local(mesh_nccl_rank, S, backend="nccl", device="cuda",
                         args=(MESH_STAGED_STEPS,), timeout_s=600, threads=0)
        for r in nccl:
            for k in KERNELS:
                launches[k] += r["launches"][k] + r["graph_launches"][k]
        emit({"phase": "mesh", "run": f"nccl x{S}", "per_rank": nccl})
    else:
        emit({"phase": "mesh", "run": "nccl across cards",
              "not_run": f"the machine has {cards} card: NCCL refuses two "
              "ranks of one communicator on one card"})
    emit({"phase": "mesh", "launches": launches,
          "wall_seconds": time.perf_counter() - t0})
    return launches


# -- persist: the PMem backend's port (`openembedding_tpu_torch/persist.py`)

PERSIST_STEPS = 12        # (s): graph steps, a persist every 2
PERSIST_HASH_STEPS = 6    # (h): the hashed flagship's graph steps
PERSIST_MESH_STEPS = 4    # (m): eager steps of each mesh configuration
PERSIST_ENTRY_STEPS = 20  # (e): one pass of the TSV, a persist every 5
# (m)'s configurations: name -> (MeshTrainer arguments, optimizer)
PERSIST_MESH_CONFIGS = {
    "d int8 hot mig": (dict(wire="int8", hot_rows=PLACE_HOT,
                            mig_rows=PLACE_MIG, hot_wire="int8"), "adagrad"),
    "a zero adam": (dict(wire="fp32", dense_shard=True), "adam"),
}


def _bits_equal(torch, mb, got: dict, want: dict) -> list:
    """The keys of two {name: tensor} dicts whose bits differ (or that one
    lacks): empty when equal bit for bit."""
    if got.keys() != want.keys():
        return sorted(set(got) ^ set(want))
    return sorted(k for k in got if got[k].shape != want[k].shape
                  or not torch.equal(mb.bits(got[k].reshape(-1)),
                                     mb.bits(want[k].reshape(-1))))


def _live_bits(torch, mb, state, rank: int = 0, by_id: bool = False) -> dict:
    """`mb.state_bits` (hash tables by id with `by_id`), the migration
    annex cut to the rows this rank owns: the other rows are copies no
    step reads, which a load refreshes."""
    out = by_id_bits(torch, mb, state) if by_id else mb.state_bits(state)
    for name, t in state.tables.items():
        if t.mig is not None:
            live = t.mig.owners == rank
            out[f"{name}/mig/weights"] = t.mig.weights[live]
            out.update({f"{name}/mig/{k}": v[live]
                        for k, v in t.mig.slots.items()})
    return out


def _history(p) -> list:
    return [{k: r.get(k) for k in ("kind", "step", "snapshot_ms",
                                   "write_ms", "bytes", "rows")}
            for r in p.history]


def _kind_stats(history, kind: str) -> dict:
    rows = [r for r in history if r["kind"] == kind]
    return {f"{kind}_count": len(rows),
            f"{kind}_snapshot_ms": [r["snapshot_ms"] for r in rows],
            f"{kind}_write_ms": [r["write_ms"] for r in rows],
            f"{kind}_bytes": [r["bytes"] for r in rows],
            **({"delta_rows": [r["rows"] for r in rows]}
               if kind == "delta" else {})}


def persist_single(torch, mb, ops, data, optimizers, tmp: str) -> dict:
    """(s) The array flagship through `jit_train_step`, 12 steps with an
    IncrementalPersister (a persist every 2 steps, a full base every third
    persist, window 2, keep 2), against the same steps with no persister;
    the root restored into a fresh state whose graph driver was captured
    before the restore: whole state bit-equal, and the step after. The
    touched-row read through the kernel against its plain version."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.persist import (
        IncrementalPersister, PersistPolicy, list_deltas, list_persists,
        read_touched_rows, restore_server_model)
    batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                         seed=TRAIN_SEED,
                                         steps=PERSIST_STEPS + 1))
    model = make_deepfm(vocabulary=VOCAB, dim=DIM)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    state = trainer.init(batches[0])
    off = state.clone()
    root = os.path.join(tmp, "single")

    def timed(step, st, p=None):
        """Each step timed (its persist included), and the step, the
        tracker's `observe` and `maybe_persist` apart -> (state, ms a
        step, {part: ms a step})."""
        ms, parts = [], {"step": [], "observe": [], "maybe_persist": []}
        for b in batches[:PERSIST_STEPS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = step(st, b)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if p is not None:
                p.observe(b)
                t2 = time.perf_counter()
                p.maybe_persist(st)
                torch.cuda.synchronize()
            t3 = time.perf_counter()
            ms.append((t3 - t0) * 1e3)
            parts["step"].append((t1 - t0) * 1e3)
            if p is not None:
                parts["observe"].append((t2 - t1) * 1e3)
                parts["maybe_persist"].append((t3 - t2) * 1e3)
        return st, ms, parts

    step_off = trainer.jit_train_step()
    off, off_ms, _ = timed(step_off, off)
    step = trainer.jit_train_step()
    ops.reset_launch_counts()  # the path's run: counts read just after
    p = IncrementalPersister(trainer, model, root, window=2, keep=2,
                             policy=PersistPolicy(every_steps=2),
                             full_every=3)
    try:
        state, on_ms, on_parts = timed(step, state, p)
        t0 = time.perf_counter()
        p.wait()
        drain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        p.close()
    launches = ran_launches(ops.launch_counts(), [graph_record(step)])
    history = _history(p)
    check([r["kind"] for r in history] == ["full", "delta", "delta",
                                           "delta", "full", "delta"],
          f"(s): fulls at steps 2 and 10, deltas between ({history})")
    check([s for s, _ in list_persists(root)] == [2, 10]
          and [s for s, _ in list_deltas(root)] == [12],
          "(s): keep=2 fulls, the deltas below the newest full pruned")
    check(launches["gather_rows"] > 0 and launches["fused_sparse_apply"] > 0,
          f"(s) launched both kernels ({launches})")

    # restore into a fresh state whose graph driver was captured first
    fresh_trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    fresh = fresh_trainer.init(batches[0])
    drv = fresh_trainer.jit_train_step()
    fresh, _ = drv(fresh, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = restore_server_model(fresh, model, root, trainer=fresh_trainer)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    unequal = _bits_equal(torch, mb, mb.state_bits(fresh),
                          mb.state_bits(state))
    check(not unequal and fresh.step == state.step == PERSIST_STEPS,
          f"(s): the restored state equals the live one ({unequal})")
    fresh, m1 = drv(fresh, batches[PERSIST_STEPS])
    state, m2 = step(state, batches[PERSIST_STEPS])
    unequal_next = _bits_equal(torch, mb, mb.state_bits(fresh),
                               mb.state_bits(state))
    check(not unequal_next and torch.equal(m1["loss"], m2["loss"]),
          f"(s): the step after the restore equals the live one "
          f"({unequal_next})")

    # the touched-row read of the last delta's ids, kernel against plain
    spec, ts = model.specs["categorical"], state.tables["categorical"]
    ids = np.unique(np.concatenate([b["sparse"]["categorical"].reshape(-1)
                                    for b in batches[10:12]]))
    ids_t = torch.from_numpy(ids.astype(np.int64)).cuda()

    def read():
        return read_touched_rows(spec, ts, ids_t)

    found, w, slots = read()
    with ops.plain_versions():
        pfound, pw, pslots = read()
    read_equal = (torch.equal(found, pfound) and torch.equal(w, pw)
                  and all(torch.equal(slots[k], pslots[k]) for k in slots))
    check(read_equal, "(s): the touched-row read through the kernel "
          "equals its plain version, bit for bit")
    read_ms = mb.device_ms(read)
    snapshot_bytes = sum(t.numel() * t.element_size()
                         for t in mb.state_bits(state).values())
    on = sorted(on_ms[2:])
    off_sorted = sorted(off_ms[2:])
    rec = {"run": "persist (s)", "steps": PERSIST_STEPS,
           "launches": launches, "history": history,
           **_kind_stats(history, "full"), **_kind_stats(history, "delta"),
           "touched_ids_last_delta": int(ids.size),
           "touched_read_bit_equal_plain": read_equal,
           "touched_read_ms": read_ms,
           "restore_ms": restore_ms, "drain_ms": drain_ms,
           "step_ms_on": on_ms, "step_ms_off": off_ms,
           "step_ms_on_parts": on_parts,
           "step_ms_on_median": on[len(on) // 2],
           "step_ms_off_median": off_sorted[len(off_sorted) // 2],
           "restored_driver_captures": drv.captures,
           "host_bytes_per_pending_full": snapshot_bytes}
    del fresh, off, state
    return rec


def persist_hash(torch, mb, ops, data, optimizers, tsv: str,
                 tmp: str) -> dict:
    """(h) The hashed flagship on the TSV, 6 graph steps, a persist every
    2 (a full base, then deltas; `full_every=2`); the root restored into a
    fresh state equals the live one by id -> rows, and in its dense part
    and counters bit for bit."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.persist import (
        IncrementalPersister, PersistPolicy, restore_server_model)
    batches = _tsv_batches(data, tsv, HASH_ID_SPACE, PERSIST_HASH_STEPS)
    model = make_deepfm(VOCAB, DIM, hashed=True, capacity=HASH_CAPACITY)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    state = trainer.init(batches[0])
    root = os.path.join(tmp, "hash")
    step = trainer.jit_train_step()
    ops.reset_launch_counts()  # the path's run: counts read just after
    with IncrementalPersister(trainer, model, root, window=2,
                              policy=PersistPolicy(every_steps=2),
                              full_every=2) as p:
        for b in batches:
            state, _ = step(state, b)
            p.maybe_persist(state, batch=b)
    launches = ran_launches(ops.launch_counts(), [graph_record(step)])
    history = _history(p)
    check([r["kind"] for r in history] == ["full", "delta", "delta"],
          f"(h): a full base, then deltas ({history})")
    fresh_trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
    fresh = fresh_trainer.init(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = restore_server_model(fresh, model, root, trainer=fresh_trainer)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    unequal = _bits_equal(torch, mb, by_id_bits(torch, mb, fresh),
                          by_id_bits(torch, mb, state))
    check(not unequal and fresh.step == state.step,
          f"(h): the restored table equals the live one by id ({unequal})")
    ts = state.tables["categorical"]
    rec = {"run": "persist (h)", "steps": PERSIST_HASH_STEPS,
           "launches": launches, "history": history,
           **_kind_stats(history, "full"), **_kind_stats(history, "delta"),
           "resident": int((ts.keys >= 0).sum()),
           "overflow": int(ts.overflow), "restore_ms": restore_ms}
    del fresh, state
    return rec


def persist_mesh_rank(mesh, tmp: str):
    """(m) One rank of four (gloo, its tensors on the card): the flagship at
    2^22 rows a shard, global batch 4096, each configuration of
    `PERSIST_MESH_CONFIGS` 4 eager steps with an IncrementalPersister (a
    persist every 2 steps, `full_every=2`); the root restored at S = 4 into
    a fresh state with the same placement: bit-equal, and the step after;
    restored into a single-device Trainer: this rank's rows (id = l*S +
    r) and the dense part equal to the live state's. Returns numpy and
    plain numbers only."""
    import torch
    from openembedding_tpu_torch import data, ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    from openembedding_tpu_torch.persist import (
        IncrementalPersister, PersistPolicy, restore_server_model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S, r = mesh.size, mesh.rank
    check(mesh.staged and S == MESH_STAGED, f"a staged mesh {mesh}")
    globals_ = list(data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED,
        steps=PERSIST_MESH_STEPS + 1))
    batches = [local_batch(b, mesh) for b in globals_]
    uniq, cnt = np.unique(np.concatenate(
        [b["sparse"]["categorical"].reshape(-1) for b in globals_]),
        return_counts=True)
    order = np.argsort(-cnt, kind="stable")
    hot_ids = uniq[order][:PLACE_HOT].astype(np.int64)
    cold = uniq[order][-PLACE_MIG:].astype(np.int64)
    moves = (cold, (cold + 1) % S)
    opts = {"adagrad": lambda: optimizers.Adagrad(learning_rate=0.05),
            "adam": lambda: optimizers.Adam(learning_rate=0.001)}
    out = {"rank": r, "runs": []}
    for name, (kw, opt) in PERSIST_MESH_CONFIGS.items():
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)

        def trainer_of():
            return MeshTrainer(model, opts[opt](), mesh=mesh, **kw)

        def placed(tr, st):
            if tr.hot_enabled:
                st = tr.refresh_hot_rows(st, hot_ids={"categorical":
                                                      hot_ids})
            if tr.mig_enabled:
                st = tr.migrate_rows(st, moves={"categorical": moves})
            return st

        trainer = trainer_of()
        state = placed(trainer, trainer.init(batches[0]))
        root = os.path.join(tmp, name.split()[0])
        ops.reset_launch_counts()  # the path's run: counts read just after
        staged0 = mesh.staged_bytes
        with IncrementalPersister(trainer, model, root, window=2,
                                  policy=PersistPolicy(every_steps=2),
                                  full_every=2) as p:
            for b in batches[:PERSIST_MESH_STEPS]:
                state, _ = trainer.train_step(state, b)
                p.maybe_persist(state, batch=b)
        launches = _mesh_launches(ops.launch_counts())
        staged = mesh.staged_bytes - staged0
        history = _history(p)
        check([h["kind"] for h in history] == ["full", "delta"],
              f"rank {r} {name}: a full base, then a delta ({history})")
        delta = os.path.join(root, "delta_%012d" % PERSIST_MESH_STEPS)
        files = sorted(os.listdir(delta))
        check(all(f"table_categorical.p{q}.npz" in files
                  and f"done.{q}" in files for q in range(S))
              and "COMMIT" in files,
              f"rank {r} {name}: one delta file and one marker a rank, "
              f"committed ({files})")
        fresh_trainer = trainer_of()
        fresh = placed(fresh_trainer, fresh_trainer.init(batches[0]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = restore_server_model(fresh, model, root,
                                     trainer=fresh_trainer)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        unequal = _bits_equal(torch, mb, _live_bits(torch, mb, fresh, r),
                              _live_bits(torch, mb, state, r))
        check(not unequal, f"rank {r} {name}: the restored state equals "
              f"the live one ({unequal})")
        nxt = batches[PERSIST_MESH_STEPS]
        fresh, m1 = fresh_trainer.train_step(fresh, nxt)
        live, m2 = trainer.train_step(state.clone(), nxt)
        unequal_next = _bits_equal(torch, mb, _live_bits(torch, mb, fresh, r),
                                   _live_bits(torch, mb, live, r))
        check(not unequal_next and torch.equal(m1["loss"], m2["loss"]),
              f"rank {r} {name}: the step after the restore equals the "
              f"live one ({unequal_next})")
        del fresh, live, fresh_trainer
        # one device: this rank's rows and the dense part of the live state
        ext = trainer.externalize(state)
        one = Trainer(make_deepfm(vocabulary=VOCAB, dim=DIM), opts[opt]())
        single = one.init(batches[0])
        single = restore_server_model(single, one.model, root, trainer=one)
        rows = torch.arange(ext.tables["categorical"].weights.shape[0],
                            device=mesh.device) * S + r
        got, want = mb.state_bits(single), mb.state_bits(ext)
        t = single.tables["categorical"]
        mismatch = [k for k in got if k.startswith("dense")
                    and not torch.equal(mb.bits(got[k]), mb.bits(want[k]))]
        for k, v in [("weights", t.weights), *t.slots.items()]:
            mine = v[rows]
            if not torch.equal(mb.bits(mine), mb.bits(
                    want[f"categorical/{k}"])):
                mismatch.append(f"categorical/{k}")
        check(not mismatch and single.step == state.step,
              f"rank {r} {name}: the single-device restore equals the "
              f"live state by id ({mismatch})")
        del single, one, ext
        out["runs"].append({
            "config": name, "launches": launches, "history": history,
            **_kind_stats(history, "full"),
            **_kind_stats(history, "delta"),
            "staged_bytes": staged, "restore_ms": restore_ms})
        del trainer, state
        torch.cuda.empty_cache()
    return out


def persist_mesh(torch, tmp: str) -> dict:
    from openembedding_tpu_torch.parallel.multihost import run_local
    t0 = time.perf_counter()
    ranks = run_local(persist_mesh_rank, MESH_STAGED, backend="gloo",
                      device="cuda", args=(os.path.join(tmp, "mesh"),),
                      timeout_s=600, threads=0)
    rec = {"run": "persist (m) mesh4-staged", "ranks": MESH_STAGED,
           "wall_seconds": time.perf_counter() - t0, "per_rank": ranks}
    for out in ranks:
        for run in out["runs"]:
            for k in ("gather_rows", "fused_sparse_apply"):
                check(run["launches"][k] > 0, f"rank {out['rank']} "
                      f"({run['config']}) launched {k}")
    # only rank 0 commits: its history holds the committed bytes
    check(all(h["bytes"] is None for out in ranks[1:] for run in out["runs"]
              for h in run["history"])
          and all(h["bytes"] > 0 for run in ranks[0]["runs"]
                  for h in run["history"]),
          "(m): rank 0 alone committed each persist")
    return rec


def persist_entry(torch, mb, ops, data, tsv: str, tmp: str) -> dict:
    """(e) The entry point's `--persist ROOT --persist-steps 5
    --persist-incremental` over the TSV: the root restored into a fresh
    state equals the state `main` returns."""
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    from openembedding_tpu_torch.persist import restore_server_model
    root = os.path.join(tmp, "entry")
    out, launches = _run_main(ops, ex, [
        "--data", tsv, "--vocabulary", str(VOCAB), "--dim", str(DIM),
        "--batch-size", str(BATCH), "--steps", str(PERSIST_ENTRY_STEPS),
        "--persist", root, "--persist-steps", "5", "--persist-incremental"])
    history = _history(out["persister"])
    check(out["persist"] == root and [h["kind"] for h in history]
          == ["full", "delta", "delta", "delta"],
          f"(e): a full base at step 5, then deltas ({history})")
    trainer = out["trainer"]
    fresh = trainer.init(_tsv_batches(data, tsv, VOCAB, 1)[0])
    fresh = restore_server_model(fresh, out["model"], root, trainer=trainer)
    unequal = _bits_equal(torch, mb, mb.state_bits(fresh),
                          mb.state_bits(out["state"]))
    check(not unequal and fresh.step == PERSIST_ENTRY_STEPS,
          f"(e): the restored state equals main's ({unequal})")
    return {"run": "persist (e) entry point", "launches": launches,
            "history": history, **_kind_stats(history, "full"),
            **_kind_stats(history, "delta"),
            "steady_ms_per_step": out["steady_seconds"] * 1e3
            / max(out["steady_steps"], 1)}


def persist_nccl_rank(mesh, tmp: str):
    """Over NCCL across cards: the flagship at fp32, 4 graph steps with an
    IncrementalPersister (every 2, `full_every=2`), restored into a fresh
    state: bit-equal on every rank."""
    import torch
    from openembedding_tpu_torch import data, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    from openembedding_tpu_torch.persist import (
        IncrementalPersister, PersistPolicy, restore_server_model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = [local_batch(b, mesh) for b in data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=TRAIN_SEED, steps=PERSIST_MESH_STEPS)]
    model = make_deepfm(vocabulary=VOCAB, dim=DIM)
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                          mesh=mesh, wire="fp32")
    state = trainer.init(batches[0])
    step = trainer.jit_train_step()
    with IncrementalPersister(trainer, model, tmp, window=2,
                              policy=PersistPolicy(every_steps=2),
                              full_every=2) as p:
        for b in batches:
            state, _ = step(state, b)
            p.maybe_persist(state, batch=b)
    fresh_trainer = MeshTrainer(model, optimizers.Adagrad(
        learning_rate=0.05), mesh=mesh, wire="fp32")
    fresh = restore_server_model(fresh_trainer.init(batches[0]), model, tmp,
                                 trainer=fresh_trainer)
    unequal = _bits_equal(torch, mb, mb.state_bits(fresh),
                          mb.state_bits(state))
    check(not unequal, f"rank {mesh.rank}: NCCL restore equals the live "
          f"state ({unequal})")
    return {"rank": mesh.rank, "history": _history(p),
            "captures": step.captures}


def phase_persist(torch, mb, ops, data, optimizers, tsv: str) -> dict:
    """Persistence (`openembedding_tpu_torch/persist.py`): (s) the array
    flagship, (h) the hashed flagship, (m) four staged ranks in two
    configurations, (e) the entry point's --persist, and NCCL across cards
    where there are some -> {kernel: launches of the phase}."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-persist-")
    try:
        runs = [persist_single(torch, mb, ops, data, optimizers, tmp)]
        emit({"phase": "persist", **runs[-1]})
        torch.cuda.empty_cache()
        runs.append(persist_hash(torch, mb, ops, data, optimizers, tsv, tmp))
        emit({"phase": "persist", **runs[-1]})
        torch.cuda.empty_cache()
        mesh = persist_mesh(torch, tmp)
        emit({"phase": "persist", **mesh})
        torch.cuda.empty_cache()
        runs.append(persist_entry(torch, mb, ops, data, tsv, tmp))
        emit({"phase": "persist", **runs[-1]})
        torch.cuda.empty_cache()
        launches = {k: sum(r["launches"][k] for r in runs) for k in KERNELS}
        for out in mesh["per_rank"]:
            for run in out["runs"]:
                for k in KERNELS:
                    launches[k] += run["launches"][k]
        cards = torch.cuda.device_count()
        if cards >= 2:
            from openembedding_tpu_torch.parallel.multihost import run_local
            S = min(4, cards)
            nccl = run_local(persist_nccl_rank, S, backend="nccl",
                             device="cuda",
                             args=(os.path.join(tmp, "nccl"),),
                             timeout_s=600, threads=0)
            emit({"phase": "persist", "run": f"nccl x{S}",
                  "per_rank": nccl})
        else:
            emit({"phase": "persist", "run": "nccl across cards",
                  "not_run": f"the machine has {cards} card: NCCL refuses "
                  "two ranks of one communicator on one card"})
        for k in ("gather_rows", "fused_sparse_apply"):
            check(launches[k] > 0, f"the persist path launched {k}")
        emit({"phase": "persist", "launches": launches,
              "wall_seconds": time.perf_counter() - t0})
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


OFFLOAD_CAPACITY = 1 << 17    # the cache: 2^17 slots, 78,643 under the mark
OFFLOAD_SCAN_CAPACITY = 1 << 18  # --scan K: the cache holds a window's union
OFFLOAD_HIGH_WATER = 0.6
OFFLOAD_STEPS = 40            # two passes of the 20-batch TSV
OFFLOAD_ENTRY_STEPS = 20      # the entry point: one pass a run
OFFLOAD_K = 4                 # its --scan K
OFFLOAD_MESH = 4              # mesh4-offload: ranks on the one card (gloo)
OFFLOAD_MESH_CAPACITY = 4 * (1 << 15)
OFFLOAD_MESH_BIG = 4 * (1 << 19)   # its in-HBM twin's slots
OFFLOAD_MESH_STEPS = 6
EVAL_CALLS = 5                # (o6): jit_eval_step calls


def _offload_model(capacity: int, storage: str = "host_cached",
                   constant: bool = False):
    """The hashed flagship, its table host-cached (or in HBM) at `capacity`
    slots; `constant`: a Constant(0.0) table (the cache then equals a large
    in-HBM table bit for bit)."""
    import dataclasses
    from openembedding_tpu_torch.initializers import Constant
    from openembedding_tpu_torch.models import make_deepfm
    model = make_deepfm(VOCAB, DIM, hashed=True, capacity=capacity)
    spec = model.specs["categorical"]
    model.specs["categorical"] = dataclasses.replace(
        spec, storage=storage,
        initializer=Constant(0.0) if constant else spec.initializer)
    return model


def _medians(ot) -> dict:
    """The median ms of each timed part of a host-cached table."""
    return {k: float(np.median(v)) for k, v in ot.timings.items() if v}


def _store_bits(torch, store) -> dict:
    return {"store/ids": torch.from_numpy(store.ids.view(np.int32)),
            "store/weights": torch.from_numpy(store.weights),
            **{f"store/{k}": torch.from_numpy(v)
               for k, v in store.slots.items()}}


def _offload_bits(torch, mb, trainer, state, cache: bool = True) -> dict:
    """A host-cached run's whole state by id: the cache's residents (unless
    `cache` is False: a restore's cache starts empty), every dense tensor,
    and the store with the residents written back."""
    out = {k: v.cpu() for k, v in by_id_bits(torch, mb, state).items()
           if cache or k.split("/")[0] not in trainer.offload}
    for name, store in trainer.offload_store_snapshots(state).items():
        out.update({f"{name}/{k}": v for k, v in
                    _store_bits(torch, store).items()})
    return out


def _same(torch, mb, got: dict, want: dict, what: str) -> list:
    check(got.keys() == want.keys(), f"{what}: the same tensors")
    unequal = sorted(k for k in got if got[k].shape != want[k].shape
                     or not torch.equal(mb.bits(got[k]), mb.bits(want[k])))
    check(not unequal, f"{what}: bit-equal ({unequal})")
    return unequal


def _offload_run(torch, trainer, batches, step, stage_ahead: int = 0
                 ) -> tuple:
    """`offload_prepare` then `step` over the batches (staging
    `stage_ahead` batches ahead), synchronized around each part -> (state,
    losses, ms a prepare, ms a step)."""
    state = trainer.init(batches[0])
    for b in batches[:stage_ahead]:
        trainer.offload_stage(b)
    losses, prep, steps = [], [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = trainer.offload_prepare(state, b)
        if stage_ahead and i + stage_ahead < len(batches):
            trainer.offload_stage(batches[i + stage_ahead])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss"].clone())
        torch.cuda.synchronize()
        prep.append((t1 - t0) * 1e3)
        steps.append((time.perf_counter() - t1) * 1e3)
    return (state, torch.stack(losses).cpu().numpy(), prep[WARM_STEPS:],
            steps[WARM_STEPS:])


def _offload_launches(ot, steps: int) -> dict:
    """The launches a run of prepared steps must make: one gather and one
    apply a step, four gathers an eviction (the cold and hot rows and
    their accumulators), two a read of the residents (flush, snapshot)."""
    c = ot.counters
    return {"gather_rows": steps + 4 * c["evictions"]
            + 2 * c["resident_reads"],
            "gather_rows_windows": 0, "fused_sparse_apply": steps}


def offload_single(torch, mb, ops, optimizers, batches) -> dict:
    """(o1) the cache through `jit_train_step` against the plain versions,
    (o2) a Constant(0.0) cache against the in-HBM flagship of 2^24 slots,
    (o3) pipelined staging against (o1)."""
    from openembedding_tpu_torch.model import Trainer
    rec, launches = {}, {k: 0 for k in KERNELS}

    def trainer(model, **kw):
        return Trainer(model, optimizers.Adagrad(learning_rate=0.05), **kw)

    # (o1): the graph run, the counts set to 0 just before and read after
    t1 = trainer(_offload_model(OFFLOAD_CAPACITY))
    step = t1.jit_train_step()
    ops.reset_launch_counts()
    state, losses, prep, step_ms = _offload_run(torch, t1, batches, step)
    ot = t1.offload["categorical"]
    store_rows, store_bytes = len(ot.store), ot.store.nbytes()
    bits = _offload_bits(torch, mb, t1, state)
    graph = graph_record(step)
    ran = ran_launches(ops.launch_counts(), [graph])
    want = _offload_launches(ot, OFFLOAD_STEPS)
    check(row_launches(ran) == want, f"(o1) launches {ran} are one gather "
          f"and one apply a step, four gathers an eviction, two a resident "
          f"read ({want})")
    check(step.captures == 1, f"(o1) one capture across the evictions "
          f"({step.captures})")
    c = ot.counters
    check(c["evictions"] >= 3, f"(o1) evicted at least three times ({c})")
    check(store_rows > OFFLOAD_CAPACITY, f"(o1) the store ({store_rows} "
          f"rows) holds more ids than the cache has slots")
    check(c["readmitted"] > 0, f"(o1) rows came back from the store ({c})")
    for k in KERNELS:
        launches[k] += ran[k]
    rec["o1"] = {
        "steps": OFFLOAD_STEPS, "capacity": OFFLOAD_CAPACITY,
        "high_water": OFFLOAD_HIGH_WATER,
        "under_the_mark": int(OFFLOAD_HIGH_WATER * OFFLOAD_CAPACITY),
        "counters": dict(c), "store_rows": store_rows,
        "store_bytes": store_bytes, "resident": ot.resident_count,
        "device_cache_bytes": ot.device_cache_bytes(),
        "prepare_ms_median": float(np.median(prep)),
        "graph_step_ms_median": float(np.median(step_ms)),
        "part_ms_median": _medians(ot), "graph": graph, "launches": ran,
        "losses_first_last": [float(losses[0]), float(losses[-1])]}
    del state, step, t1
    torch.cuda.empty_cache()

    ref_t = trainer(_offload_model(OFFLOAD_CAPACITY))
    with ops.plain_versions():
        ops.reset_launch_counts()
        ref, ref_losses, _, _ = _offload_run(torch, ref_t, batches,
                                             ref_t.train_step)
        check(sum(ops.launch_counts().values()) == 0,
              "the plain run launched no kernel")
        ref_bits = _offload_bits(torch, mb, ref_t, ref)
    check(np.array_equal(losses.view(np.int32), ref_losses.view(np.int32)),
          "(o1) losses bit-equal to the plain run's")
    _same(torch, mb, bits, ref_bits, "(o1) vs plain (cache and store by id)")
    rec["o1"]["bit_equal_vs_plain"] = True
    del ref, ref_t
    torch.cuda.empty_cache()

    # (o3): pipelined staging, a ring of two, densified writebacks; one
    # batch ahead (staged after the previous admission) and two ahead
    # (staged before it: stale where the two batches share new ids)
    rec["o3"] = {}
    for ahead in (1, 2):
        t3 = trainer(_offload_model(OFFLOAD_CAPACITY),
                     offload_pipeline=True, offload_stage_depth=2,
                     offload_densify=4)
        step = t3.jit_train_step()
        ops.reset_launch_counts()
        state, losses3, prep3, _ = _offload_run(torch, t3, batches, step,
                                                stage_ahead=ahead)
        ot3 = t3.offload["categorical"]
        bits3 = _offload_bits(torch, mb, t3, state)
        ran = ran_launches(ops.launch_counts(), [graph_record(step)])
        check(row_launches(ran) == _offload_launches(ot3, OFFLOAD_STEPS),
              f"(o3, {ahead} ahead) launches {ran}")
        for k in KERNELS:
            launches[k] += ran[k]
        check(np.array_equal(losses3.view(np.int32),
                             ref_losses.view(np.int32)),
              f"(o3, {ahead} ahead) losses bit-equal to (o1)'s")
        _same(torch, mb, bits3, ref_bits, f"(o3, {ahead} ahead) vs (o1)")
        check(ot3.pipe_hits > 0, f"(o3, {ahead} ahead) staged payloads "
              f"consumed ({ot3.pipe_hits} hits, {ot3.pipe_misses} misses)")
        ot3.close()
        rec["o3"][f"{ahead}_ahead"] = {
            "bit_equal_vs_o1": True, "pipe_hits": ot3.pipe_hits,
            "pipe_misses": ot3.pipe_misses, "slot_hits": ot3.slot_hits,
            "slot_misses": ot3.slot_misses,
            "occupancy": ot3.pipeline_occupancy,
            "counters": dict(ot3.counters),
            "prepare_ms_median": float(np.median(prep3)),
            "part_ms_median": _medians(ot3), "launches": ran}
        del state, step, t3, bits3
        torch.cuda.empty_cache()
    del ref_bits

    # (o2): Constant(0.0), the cache against the in-HBM flagship table
    t2 = trainer(_offload_model(OFFLOAD_CAPACITY, constant=True))
    step = t2.jit_train_step()
    ops.reset_launch_counts()
    state, losses2, prep2, step2 = _offload_run(torch, t2, batches, step)
    ran = ran_launches(ops.launch_counts(), [graph_record(step)])
    for k in KERNELS:
        launches[k] += ran[k]
    ot2 = t2.offload["categorical"]
    store = t2.offload_store_snapshots(state)["categorical"]
    del state, step
    torch.cuda.empty_cache()
    th = trainer(_offload_model(HASH_CAPACITY, "hbm", constant=True))
    hstep = th.jit_train_step()
    ops.reset_launch_counts()
    hstate = th.init(batches[0])
    hlosses, hstep_ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hstate, m = hstep(hstate, b)
        hlosses.append(m["loss"].clone())
        torch.cuda.synchronize()
        hstep_ms.append((time.perf_counter() - t0) * 1e3)
    ran = ran_launches(ops.launch_counts(), [graph_record(hstep)])
    for k in KERNELS:
        launches[k] += ran[k]
    hlosses = torch.stack(hlosses).cpu().numpy()
    ts = hstate.tables["categorical"]
    sel = torch.nonzero(ts.keys >= 0).squeeze(1)
    order = sel[torch.argsort(ts.keys[sel])]
    hbm = {"store/ids": torch.from_numpy(
               ts.keys[order].cpu().numpy().view(np.int32)),
           "store/weights": ts.weights[order].cpu(),
           "store/accum": ts.slots["accum"][order].cpu()}
    losses_equal = np.array_equal(losses2.view(np.int32),
                                  hlosses.view(np.int32))
    check(losses_equal, "(o2) losses bit-equal to the in-HBM table's")
    _same(torch, mb, _store_bits(torch, store), hbm,
          "(o2) rows by id vs the in-HBM table")
    rec["o2"] = {"bit_equal_vs_in_hbm": True,
                 "counters": dict(ot2.counters),
                 "prepare_ms_median": float(np.median(prep2)),
                 "graph_step_ms_median": float(np.median(step2)),
                 "in_hbm_graph_step_ms_median": float(np.median(
                     hstep_ms[WARM_STEPS:])),
                 "in_hbm_resident": int(sel.numel())}
    del hstate, hstep, th, t2
    torch.cuda.empty_cache()
    rec["launches"] = launches
    return rec


def offload_entry(torch, mb, ops, data, optimizers, tsv: str,
                  tmp: str) -> dict:
    """(o4) the entry point's --offload over the TSV: stepwise with
    --persist, and with --scan K (a cache of OFFLOAD_SCAN_CAPACITY slots,
    which holds a window's union under the mark), each with --save and
    --export."""
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    from openembedding_tpu_torch.export import StandaloneModel
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.persist import restore_server_model
    base = ["--data", tsv, "--vocabulary", str(HASH_ID_SPACE), "--dim",
            str(DIM), "--batch-size", str(BATCH),
            "--steps", str(OFFLOAD_ENTRY_STEPS)]
    first = _tsv_batches(data, tsv, HASH_ID_SPACE, 1)[0]
    runs, launches = [], {k: 0 for k in KERNELS}
    for what, extra in (("step", ["--offload", str(OFFLOAD_CAPACITY),
                                  "--persist", os.path.join(tmp, "root"),
                                  "--persist-steps",
                                  str(OFFLOAD_ENTRY_STEPS // 4)]),
                        ("scan", ["--offload", str(OFFLOAD_SCAN_CAPACITY),
                                  "--scan", str(OFFLOAD_K)])):
        ckpt = os.path.join(tmp, f"ckpt_{what}")
        export = os.path.join(tmp, f"export_{what}")
        out, ran = _run_main(ops, ex, base + extra + ["--save", ckpt,
                                                      "--export", export])
        trainer, state = out["trainer"], out["state"]
        ot = trainer.offload["categorical"]
        steps = OFFLOAD_ENTRY_STEPS
        # the save and the export each read the residents once more
        check(ran["fused_sparse_apply"] == steps
              and ran["gather_rows"] == steps + 4 * ot.counters["evictions"]
              + 2 * ot.counters["resident_reads"],
              f"(o4 {what}) launches {ran} ({dict(ot.counters)})")
        for k in KERNELS:
            launches[k] += ran[k]
        store = trainer.offload_store_snapshots(state)["categorical"]
        rec = {"run": f"entry --offload {what}", "counters": dict(ot.counters),
               "store_rows": len(store),
               "examples_per_s": out["examples_per_s"],
               "steady_ms_per_step": out["steady_seconds"] * 1e3
               / max(out["steady_steps"], 1)}
        check(ot.counters["evictions"] + ot.counters["flushes"] > 0,
              f"(o4 {what}) the cache evicted ({dict(ot.counters)})")
        state = trainer.offload_prepare(state, first)
        ops.reset_launch_counts()
        served = StandaloneModel.load(export)
        logits = served.predict(first)
        want = trainer.eval_step(state, first)["logits"]
        got = ops.launch_counts()
        for k in KERNELS:
            launches[k] += got[k]
        rec["export_logits_equal_eval_step"] = bool(torch.equal(
            logits.reshape(-1), want.reshape(-1)))
        check(rec["export_logits_equal_eval_step"],
              f"(o4 {what}) the export's logits equal eval_step's")
        del served
        # the checkpoint into the in-HBM hashed flagship, by id
        plain = Trainer(_offload_model(HASH_CAPACITY, "hbm"),
                        optimizers.Adagrad(learning_rate=0.05))
        ops.reset_launch_counts()
        loaded = plain.load(plain.init(first), ckpt)
        ts = loaded.tables["categorical"]
        sel = torch.nonzero(ts.keys >= 0).squeeze(1)
        order = sel[torch.argsort(ts.keys[sel])]
        _same(torch, mb, _store_bits(torch, store), {
            "store/ids": torch.from_numpy(
                ts.keys[order].cpu().numpy().view(np.int32)),
            "store/weights": ts.weights[order].cpu(),
            "store/accum": ts.slots["accum"][order].cpu()},
            f"(o4 {what}) the checkpoint in HBM by id")
        rec["checkpoint_in_hbm_equal_by_id"] = True
        del loaded, plain
        if what == "step":
            fresh_t = Trainer(out["model"],
                              optimizers.Adagrad(learning_rate=0.05))
            fresh = restore_server_model(fresh_t.init(first), out["model"],
                                         os.path.join(tmp, "root"),
                                         trainer=fresh_t)
            check(fresh.step == steps, f"(o4) restored step {fresh.step}")
            _same(torch, mb, _offload_bits(torch, mb, fresh_t, fresh,
                                           cache=False),
                  _offload_bits(torch, mb, trainer, out["state"],
                                cache=False),
                  "(o4) the persist root restored (store and dense)")
            rec["persist_restored_bit_equal"] = True
            rec["persists"] = len(out["persister"].history)
            del fresh, fresh_t
        got = ops.launch_counts()
        for k in KERNELS:
            launches[k] += got[k]
        runs.append(rec)
        del out, trainer, state
        torch.cuda.empty_cache()
    return {"runs": runs, "launches": launches}


def offload_mesh_rank(mesh, tmp: str):
    """(o5) one rank of four on the one card (gloo, staged): the Constant
    (0.0) cache over OFFLOAD_MESH_STEPS eager prepared steps, the same
    through the plain versions, the in-HBM mesh; a full persist and its
    restore. Returns numpy and plain values."""
    import torch
    from openembedding_tpu_torch import (AsyncPersister, PersistPolicy,
                                         data, ops, optimizers,
                                         restore_server_model)
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(mesh.staged and mesh.size == OFFLOAD_MESH, f"a staged mesh {mesh}")
    globals_ = list(data.synthetic_criteo(
        BATCH, id_space=HASH_ID_SPACE, seed=TRAIN_SEED,
        steps=OFFLOAD_MESH_STEPS))
    batches = [local_batch(b, mesh) for b in globals_]
    ids = np.unique(np.concatenate([b["sparse"]["categorical"].reshape(-1)
                                    for b in globals_]))

    def run(storage, capacity):
        trainer = MeshTrainer(_offload_model(capacity, storage,
                                             constant=True),
                              optimizers.Adagrad(learning_rate=0.05),
                              mesh=mesh, wire="fp32")
        state = trainer.init(batches[0])
        losses, ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.offload_prepare(state, b)
            state, m = trainer.train_step(state, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if trainer.offload:
            rows = trainer.offload["categorical"].lookup_anywhere(ids)
        else:
            from openembedding_tpu_torch.parallel.sharded import \
                sharded_lookup
            rows = sharded_lookup(
                trainer.model.specs["categorical"],
                state.tables["categorical"],
                torch.from_numpy(ids).to(mesh.device),
                mesh=mesh).cpu().numpy()
        return trainer, state, np.float32(losses), rows, ms

    ops.reset_launch_counts()
    trainer, state, losses, rows, ms = run("host_cached",
                                           OFFLOAD_MESH_CAPACITY)
    launches = ops.launch_counts()
    ot = trainer.offload["categorical"]
    out = {"rank": mesh.rank, "launches": launches,
           "counters": dict(ot.counters), "store_rows": len(ot.store),
           "ms_per_step": ms[1:], "losses": losses.tolist()}
    with ops.plain_versions():
        _, _, plosses, prows, _ = run("host_cached", OFFLOAD_MESH_CAPACITY)
    out["bit_equal_vs_plain"] = (losses.tobytes() == plosses.tobytes()
                                 and rows.tobytes() == prows.tobytes())
    check(out["bit_equal_vs_plain"], f"rank {mesh.rank}: (o5) bit-equal "
          "to the plain versions by id")
    _, _, hlosses, hrows, _ = run("hbm", OFFLOAD_MESH_BIG)
    out["bit_equal_vs_in_hbm"] = (losses.tobytes() == hlosses.tobytes()
                                  and rows.tobytes() == hrows.tobytes())
    check(out["bit_equal_vs_in_hbm"], f"rank {mesh.rank}: (o5) bit-equal "
          "to the in-HBM mesh by id")
    root = os.path.join(tmp, "mesh_root")
    with AsyncPersister(trainer, trainer.model, root,
                        policy=PersistPolicy(every_steps=1)) as p:
        p.persist(state)
    fresh = MeshTrainer(trainer.model, optimizers.Adagrad(learning_rate=0.05),
                        mesh=mesh, wire="fp32")
    restored = restore_server_model(fresh.init(batches[0]), fresh.model,
                                    root, trainer=fresh)
    got = fresh.offload["categorical"].lookup_anywhere(ids)
    want = trainer.offload["categorical"].lookup_anywhere(ids)
    dense_equal = all(torch.equal(mb.bits(a), mb.bits(b)) for a, b in zip(
        [p.detach() for p in restored.dense.parameters()],
        [p.detach() for p in state.dense.parameters()]))
    out["persist_restored_bit_equal"] = (got.tobytes() == want.tobytes()
                                         and dense_equal
                                         and restored.step == state.step)
    check(out["persist_restored_bit_equal"], f"rank {mesh.rank}: (o5) the "
          "persist restored bit for bit")
    return out


def offload_mesh(torch, tmp: str) -> dict:
    from openembedding_tpu_torch.parallel.multihost import run_local
    t0 = time.perf_counter()
    ranks = run_local(offload_mesh_rank, OFFLOAD_MESH, backend="gloo",
                      device="cuda", args=(tmp,), timeout_s=600, threads=0)
    for r in ranks:
        for k in ("gather_rows", "fused_sparse_apply"):
            check(r["launches"][k] > 0, f"rank {r['rank']} launched {k}")
    return {"run": "mesh4-offload", "ranks": OFFLOAD_MESH,
            "capacity": OFFLOAD_MESH_CAPACITY, "steps": OFFLOAD_MESH_STEPS,
            "wall_seconds": time.perf_counter() - t0, "per_rank": ranks}


def offload_eval(torch, mb, ops, optimizers, data) -> dict:
    """(o6) `jit_eval_step` on the array flagship: EVAL_CALLS calls, one
    capture, logits and loss bit-equal to the eager `eval_step`."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                         seed=TRAIN_SEED, steps=EVAL_CALLS))
    trainer = Trainer(make_deepfm(VOCAB, DIM),
                      optimizers.Adagrad(learning_rate=0.05))
    state = trainer.init(batches[0])
    state, _ = trainer.train_step(state, batches[0])
    ev = trainer.jit_eval_step()
    ops.reset_launch_counts()
    equal, ms = True, []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ev(state, b)
        got = {k: v.clone() for k, v in got.items()}
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        want = trainer.eval_step(state, b)
        equal = equal and all(torch.equal(mb.bits(got[k]), mb.bits(want[k]))
                              for k in ("logits", "loss"))
    ran = ran_launches(ops.launch_counts(), [graph_record(ev)])
    check(equal, "(o6) jit_eval_step's logits and loss bit-equal to "
          "eval_step's")
    check(ran["gather_rows"] == 2 * EVAL_CALLS
          and ran["fused_sparse_apply"] == 0,
          f"(o6) one gather a graph call and one an eager call ({ran})")
    rec = {"calls": EVAL_CALLS, "bit_equal_vs_eager": equal,
           "graph": graph_record(ev), "graph_call_ms": ms[1:],
           "launches": ran}
    del state, ev, trainer
    torch.cuda.empty_cache()
    return rec


def phase_offload(torch, mb, ops, data, optimizers, tsv: str,
                  smi: str) -> dict:
    """Host-cached tables (`tables/host_offload.py`): (o1)-(o3) on one
    device over two passes of the TSV, (o4) the entry point, (o5) four
    staged ranks, (o6) `jit_eval_step` -> {kernel: launches of the
    phase}."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-offload-")
    try:
        batches = _tsv_batches(data, tsv, HASH_ID_SPACE, OFFLOAD_STEPS)
        new_ids = new_ids_per_step(batches)
        emit({"phase": "offload", "new_ids_per_step": new_ids,
              "distinct_ids_a_pass": sum(new_ids),
              "cache_slots": OFFLOAD_CAPACITY,
              "under_the_mark": int(OFFLOAD_HIGH_WATER * OFFLOAD_CAPACITY),
              "largest_batch_distinct": max(
                  int((np.unique(b["sparse"]["categorical"]) >= 0).sum())
                  for b in batches)})
        single = offload_single(torch, mb, ops, optimizers, batches)
        emit({"phase": "offload", **{k: v for k, v in single.items()}})
        entry = offload_entry(torch, mb, ops, data, optimizers, tsv, tmp)
        emit({"phase": "offload", "o4": entry})
        mesh = offload_mesh(torch, tmp)
        emit({"phase": "offload", "o5": mesh})
        ev = offload_eval(torch, mb, ops, optimizers, data)
        emit({"phase": "offload", "o6": ev})
        launches = {k: single["launches"][k] + entry["launches"][k]
                    + ev["launches"][k]
                    + sum(r["launches"][k] for r in mesh["per_rank"])
                    for k in KERNELS}
        for k in ("gather_rows", "fused_sparse_apply"):
            check(launches[k] > 0, f"the offload path launched {k}")
        emit({"phase": "offload", "launches": launches, "card": smi,
              "wall_seconds": time.perf_counter() - t0})
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- 15. seq: the retrieval and sequence families ------------------------------

SEQ_SEED = 5
# (q1) SASRec at Kang & McAuley (ICDM 2018) section IV-B's MovieLens-1M
# widths: 3,416 items, d = 50, one head, two blocks, n = 200, Adam(0.001),
# batch 128
SASREC = dict(vocabulary=3416, dim=50, num_heads=1, num_blocks=2,
              max_len=200)
SASREC_BATCH, SASREC_LR = 128, 0.001
SASREC_STEPS = 16          # eager, plain and jit_train_step steps
SASREC_K = 8               # jit_train_many: two windows of 8
# (q2) BERT4Rec at Sun et al. (CIKM 2019) section 4.3's ML-20m widths:
# 26,744 items, d = 64, two heads, two blocks, N = 200, Adam(1e-4),
# batch 256, mask proportion 0.2
BERT4REC = dict(vocabulary=26744, dim=64, num_heads=2, num_blocks=2,
                max_len=200)
BERT4REC_BATCH, BERT4REC_LR, BERT4REC_MASK = 256, 1e-4, 0.2
BERT4REC_STEPS = 8
# (q3) q2's model at float32 on four staged gloo ranks as a (2, 2) mesh
SEQ_MESH = (2, 2)
SEQ_MESH_STEPS = 4
SEQ_MESH_LR = 0.1          # Adagrad, as tests/test_torch_seq_mesh.py
# the CPU test's bounds at the card's widths (tests/test_torch_seq_mesh.py
# states them): logits against the single-device full-attention Trainer,
# the loss trajectory against its losses
SEQ_MESH_TOL = {"logits": 1e-5, "loss": 2e-5}
# (q4) the two-tower at the factory's widths (dim 16, tower 256-128,
# combiner mean) with MovieLens-20M's 138,493 users and 26,744 items
TWO_TOWER = dict(user_vocabulary=138493, item_vocabulary=26744, dim=16,
                 tower=(256, 128), combiner="mean")
TWO_TOWER_BATCH, TWO_TOWER_STEPS = 4096, 8
# (q5) EmbeddingVariable: a 2^24 x 10 table, 4096 x 26 Zipfian ids
VAR_ROWS, VAR_DIM, VAR_IDS = 1 << 24, 10, 4096 * 26


def _seq_clone_run(torch, mb, ops, trainer, state, batches, what):
    """Eager steps through the kernels (counts read just after), then the
    same steps from a clone through the plain versions, bit-equal ->
    (state, losses, launches, ms a step, the plain run's ms a step, the
    comparison)."""
    ref = state.clone()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = _eager(torch, trainer, state, batches)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    launches = ops.launch_counts()
    with ops.plain_versions():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref, ref_losses = _eager(torch, trainer, ref, batches)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    check(sum(ops.launch_counts().values()) == sum(launches.values()),
          f"{what}: the plain run launched no kernel")
    cmp = _compare(torch, mb, state, losses, ref, ref_losses,
                   f"{what}_eager_vs_plain")
    return state, losses, ref, ref_losses, launches, ms, plain_ms, cmp


def _seq_graph(torch, mb, ops, trainer, start, batches, ref, ref_losses,
               what, many_k: int = 0):
    """The steps from `start` through `jit_train_step` (or, with many_k,
    `jit_train_many` windows of many_k), bit-equal to the plain run ->
    the record and the launches that ran."""
    state = start
    driver = trainer.jit_train_many() if many_k else trainer.jit_train_step()
    ops.reset_launch_counts()
    losses = []
    calls = batches
    if many_k:
        calls = []
        for w in range(len(batches) // many_k):
            window = batches[w * many_k:(w + 1) * many_k]
            calls.append({"sparse": {k: np.stack([b["sparse"][k]
                                                  for b in window])
                                     for k in window[0]["sparse"]},
                          "label": np.stack([b["label"] for b in window])})
    for i, b in enumerate(calls):
        if i == 1:  # the first call warms up and captures: untimed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = driver(state, b)
        if many_k:
            losses.extend(m["loss"].clone().unbind(0))
        else:
            losses.append(m["loss"].clone())
    torch.cuda.synchronize()
    ms = ((time.perf_counter() - t0) * 1e3
          / (len(batches) - (many_k or 1)))
    ran = ran_launches(ops.launch_counts(), [graph_record(driver)])
    cmp = _compare(torch, mb, state, torch.stack(losses).cpu().numpy(), ref,
                   ref_losses, f"{what}_{'many' if many_k else 'graph'}"
                   "_vs_plain")
    return state, driver, {"ms_per_step": ms, "launches": ran,
                           "graph": graph_record(driver), **cmp}, ran


def _add(total, launches):
    for k in KERNELS:
        total[k] += launches.get(k, 0)


def seq_sasrec(torch, mb, ops, optimizers, tmp) -> dict:
    """(q1) SASRec on one card: eager, jit_train_step and jit_train_many
    (K = 8), each bit-equal over the whole state to the plain versions;
    jit_eval_step; the export served over REST equal to eval_step."""
    from openembedding_tpu_torch.export import export_standalone
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_sasrec, synthetic_sequences
    from openembedding_tpu_torch.serving import ServingClient, make_server
    total = {k: 0 for k in KERNELS}
    model = make_sasrec(**SASREC)
    trainer = Trainer(model, optimizers.Adam(learning_rate=SASREC_LR))
    batches = list(synthetic_sequences(SASREC_BATCH, SASREC["max_len"],
                                       SASREC["vocabulary"], seed=SEQ_SEED,
                                       steps=SASREC_STEPS))
    state = trainer.init(batches[0])
    start = state.clone()
    state, losses, ref, ref_losses, launches, ms, plain_ms, cmp = \
        _seq_clone_run(torch, mb, ops, trainer, state, batches, "q1")
    _add(total, launches)
    check(launches["gather_rows"] == SASREC_STEPS
          and launches["fused_sparse_apply"] == SASREC_STEPS,
          f"(q1) one gather and one apply a step ({launches})")
    rec = {"eager": {"ms_per_step": ms, "plain_ms_per_step": plain_ms,
                     "launches": launches, **cmp},
           "losses": losses.tolist()}
    check(losses[-1] < losses[0], f"(q1) the loss drops {losses}")
    for k, key in ((0, "graph"), (SASREC_K, "many")):
        gstate, driver, grec, ran = _seq_graph(
            torch, mb, ops, trainer, start.clone(), batches, ref, ref_losses,
            "q1", many_k=k)
        _add(total, ran)
        check(ran["gather_rows"] == SASREC_STEPS
              and ran["fused_sparse_apply"] == SASREC_STEPS,
              f"(q1 {key}) one gather and one apply a step ran ({ran})")
        if key == "graph":
            grec.update(profile_device(
                torch, lambda: driver(gstate, batches[-1]), unit="step"))
        rec[key] = grec
        del driver
    # jit_eval_step: one capture, bit-equal to eval_step
    ev = trainer.jit_eval_step()
    ops.reset_launch_counts()
    equal = True
    for b in batches[:3]:
        got = {k: v.clone() for k, v in ev(state, b).items()}
        want = trainer.eval_step(state, b)
        equal = equal and all(torch.equal(mb.bits(got[k]), mb.bits(want[k]))
                              for k in ("logits", "loss"))
    ran = ran_launches(ops.launch_counts(), [graph_record(ev)])
    _add(total, ran)
    check(equal and ran["gather_rows"] == 6,
          f"(q1) jit_eval_step bit-equal to eval_step, one gather a call "
          f"({ran})")
    rec["eval"] = {"bit_equal_vs_eager": equal, "launches": ran,
                   "graph": graph_record(ev)}
    # the export over REST: (n, 200, 2), equal to eval_step's logits
    export = os.path.join(tmp, "sasrec")
    export_standalone(state, model, export)
    httpd = make_server(os.path.join(tmp, "registry"), port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(f"http://127.0.0.1:{httpd.server_address[1]}",
                               timeout=300)
        client.create_model("sasrec-smoke", export)
        b = batches[1]
        ops.reset_launch_counts()
        served = client.predict("sasrec-smoke", b["sparse"])
        got = ops.launch_counts()
        _add(total, got)
        want = trainer.eval_step(state, b)["logits"].float().cpu().numpy()
        equal = bool(served.shape == want.shape
                     and np.array_equal(served, want))
        rec["rest"] = {"shape": list(served.shape), "equal_eval_step": equal,
                       "max_abs_err": float(np.abs(served - want).max()),
                       "gathers": got["gather_rows"]}
        check(equal and got["gather_rows"] == 1,
              f"(q1) REST logits {served.shape} equal eval_step's "
              f"({rec['rest']})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        check(not thread.is_alive(), "the server thread stopped")
    rec["launches"] = total
    del trainer, state, ref, start
    torch.cuda.empty_cache()
    return rec


def seq_bert4rec(torch, mb, ops, optimizers) -> dict:
    """(q2) BERT4Rec on one card: eager and jit_train_step, each bit-equal
    to the plain versions; the [MASK] row trains."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import (bert4rec_mask_id,
                                                make_bert4rec,
                                                synthetic_masked_sequences)
    total = {k: 0 for k in KERNELS}
    model = make_bert4rec(**BERT4REC)
    trainer = Trainer(model, optimizers.Adam(learning_rate=BERT4REC_LR))
    batches = list(synthetic_masked_sequences(
        BERT4REC_BATCH, BERT4REC["max_len"], BERT4REC["vocabulary"],
        mask_rate=BERT4REC_MASK, seed=SEQ_SEED, steps=BERT4REC_STEPS))
    mask_id = bert4rec_mask_id(BERT4REC["vocabulary"])
    check(all((b["sparse"]["item"][:, 0] == mask_id).any() for b in batches),
          "(q2) every batch holds the [MASK] id")
    state = trainer.init(batches[0])
    start = state.clone()
    row0 = state.tables["item"].weights[mask_id].clone()
    state, losses, ref, ref_losses, launches, ms, plain_ms, cmp = \
        _seq_clone_run(torch, mb, ops, trainer, state, batches, "q2")
    _add(total, launches)
    moved = float((state.tables["item"].weights[mask_id] - row0).abs().max())
    check(moved > 0, "(q2) the [MASK] row trains")
    rec = {"eager": {"ms_per_step": ms, "plain_ms_per_step": plain_ms,
                     "launches": launches, **cmp},
           "losses": losses.tolist(), "mask_row_moved": moved,
           "table": list(state.tables["item"].weights.shape)}
    gstate, driver, grec, ran = _seq_graph(
        torch, mb, ops, trainer, start, batches, ref, ref_losses, "q2")
    _add(total, ran)
    grec.update(profile_device(torch, lambda: driver(gstate, batches[-1]),
                               unit="step"))
    rec["graph"] = grec
    rec["launches"] = total
    del trainer, state, ref, gstate, driver
    torch.cuda.empty_cache()
    return rec


def seq_mesh_rank(mesh, start, batches):
    """(q3) one rank of the (2, 2) mesh: q2's model at float32 with ring
    attention (its steps also through the plain versions, bit-equal) and
    with Ulysses, each from the same start -> numpy only."""
    import torch
    from openembedding_tpu_torch import convert, ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.models import make_bert4rec
    from openembedding_tpu_torch.parallel import SeqMeshTrainer, make_seq_mesh
    from openembedding_tpu_torch.parallel.multihost import local_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(mesh.staged and mesh.size == 4, f"a staged mesh {mesh}")
    mesh2 = make_seq_mesh(*SEQ_MESH, device=mesh.device)
    local = [local_batch(b, mesh2) for b in batches]
    out = {"rank": mesh.rank, "runs": {}}
    for attention in ("ring", "ulysses"):
        model = make_bert4rec(**BERT4REC, attention=attention,
                              compute_dtype=torch.float32)
        trainer = SeqMeshTrainer(
            model, optimizers.Adagrad(learning_rate=SEQ_MESH_LR),
            mesh=mesh2, wire="fp32")
        state = convert.mesh_state_from_jax(start, model, mesh2.size,
                                            mesh2.rank, device=mesh.device)
        ref = state.clone() if attention == "ring" else None
        ev = trainer.eval_step(state, local[0])
        staged0 = mesh2.total_staged_bytes()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses = _eager(torch, trainer, state, local)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(local)
        launches = _mesh_launches(ops.launch_counts())
        staged = mesh2.total_staged_bytes() - staged0
        run = {"eval_logits": ev["logits"].cpu().numpy(),
               "eval_loss": float(ev["loss"]), "losses": losses.tolist(),
               "ms_per_step": ms, "launches": launches,
               "staged_bytes_per_step": staged / len(local)}
        if ref is not None:
            with ops.plain_versions():
                ref, ref_losses = _eager(torch, trainer, ref, local)
            run.update(_compare(torch, mb, state, losses, ref, ref_losses,
                                "ring_vs_plain"))
        out["runs"][attention] = run
        del trainer, state, ref
        torch.cuda.empty_cache()
    return out


def seq_mesh(torch, optimizers) -> dict:
    """(q3) `SeqMeshTrainer` on four staged gloo ranks as a (2, 2) mesh,
    ring and Ulysses, against the single-device full-attention Trainer on
    the same state."""
    from openembedding_tpu_torch import convert
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import (make_bert4rec,
                                                synthetic_masked_sequences)
    from openembedding_tpu_torch.parallel.multihost import run_local
    from openembedding_tpu_torch.parallel.sharded import interleave_rows
    S = SEQ_MESH[0] * SEQ_MESH[1]
    batches = list(synthetic_masked_sequences(
        BERT4REC_BATCH, BERT4REC["max_len"], BERT4REC["vocabulary"],
        mask_rate=BERT4REC_MASK, seed=SEQ_SEED + 1, steps=SEQ_MESH_STEPS))
    model = make_bert4rec(**BERT4REC, compute_dtype=torch.float32)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=SEQ_MESH_LR))
    state = trainer.init(batches[0])
    start = convert.train_state_to_jax(state)
    for t in start["tables"].values():   # id-major -> shard-major
        t["weights"] = interleave_rows(t["weights"], S)
        t["slots"] = {k: interleave_rows(v, S) for k, v in t["slots"].items()}
    ev = trainer.eval_step(state, batches[0])
    want_logits = ev["logits"].cpu().numpy()
    state, want_losses = _eager(torch, trainer, state, batches)
    del trainer, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_local(seq_mesh_rank, S, backend="gloo", device="cuda",
                      args=(start, batches), timeout_s=600, threads=0)
    wall = time.perf_counter() - t0
    D, P = SEQ_MESH
    rec = {"mesh": list(SEQ_MESH), "wall_seconds": wall, "runs": {}}
    total = {k: 0 for k in KERNELS}
    for attention in ("ring", "ulysses"):
        runs = [r["runs"][attention] for r in ranks]
        rows = [np.concatenate([runs[d * P + s]["eval_logits"]
                                for s in range(P)], axis=1)
                for d in range(D)]
        logits = np.concatenate(rows, axis=0)
        logit_err = float(np.abs(logits - want_logits).max())
        loss_err = max(float(np.abs(np.asarray(r["losses"])
                                    - want_losses).max()) for r in runs)
        check(logit_err <= SEQ_MESH_TOL["logits"],
              f"(q3 {attention}) logits within {SEQ_MESH_TOL['logits']} of "
              f"the single-device Trainer ({logit_err})")
        check(loss_err <= SEQ_MESH_TOL["loss"],
              f"(q3 {attention}) losses within {SEQ_MESH_TOL['loss']} of "
              f"the single-device Trainer ({loss_err})")
        for r in runs:
            for k in ("gather_rows", "fused_sparse_apply"):
                check(r["launches"][k] > 0, f"(q3 {attention}) a rank "
                      f"launched {k}")
            _add(total, r["launches"])
        rec["runs"][attention] = {
            "logits_max_abs_err_vs_single_device": logit_err,
            "loss_max_abs_err_vs_single_device": loss_err,
            "losses": runs[0]["losses"], "single_device_losses":
                want_losses.tolist(),
            "ms_per_step": [r["ms_per_step"] for r in runs],
            "staged_bytes_per_step": [r["staged_bytes_per_step"]
                                      for r in runs],
            "launches": [r["launches"] for r in runs],
            **({"ring_vs_plain": [
                {k: v for k, v in r.items() if "vs_plain" in k}
                for r in runs]} if attention == "ring" else {})}
    rec["launches"] = total
    rec["nccl"] = ("not run: one card" if torch.cuda.device_count() < 4
                   else seq_mesh_nccl(torch, start, batches, want_logits,
                                      want_losses, rec))
    return rec


def seq_mesh_nccl_rank(mesh, start, batches):
    """(q3, four cards) the ring run over NCCL through jit_train_step,
    captured once -> numpy only."""
    import torch
    from openembedding_tpu_torch import convert, ops, optimizers
    from openembedding_tpu_torch.models import make_bert4rec
    from openembedding_tpu_torch.parallel import SeqMeshTrainer, make_seq_mesh
    from openembedding_tpu_torch.parallel.multihost import local_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh2 = make_seq_mesh(*SEQ_MESH, device=mesh.device)
    local = [local_batch(b, mesh2) for b in batches]
    model = make_bert4rec(**BERT4REC, attention="ring",
                          compute_dtype=torch.float32)
    trainer = SeqMeshTrainer(model, optimizers.Adagrad(
        learning_rate=SEQ_MESH_LR), mesh=mesh2, wire="fp32")
    state = convert.mesh_state_from_jax(start, model, mesh2.size, mesh2.rank,
                                        device=mesh.device)
    eager = state.clone()
    eager, eager_losses = _eager(torch, trainer, eager, local)
    step = trainer.jit_train_step()
    ops.reset_launch_counts()
    state, losses, ms = _graph_steps(torch, step, state, local + local)
    rec = graph_record(step)
    return {"losses": losses.tolist(), "eager_losses": eager_losses.tolist(),
            "ms_per_step": ms, "graph": rec,
            "launches": ran_launches(ops.launch_counts(), [rec])}


def seq_mesh_nccl(torch, start, batches, want_logits, want_losses, rec):
    from openembedding_tpu_torch.parallel.multihost import run_local
    ranks = run_local(seq_mesh_nccl_rank, 4, backend="nccl", device="cuda",
                      args=(start, batches), timeout_s=600, threads=0)
    for r in ranks:
        n = len(batches)
        check(r["losses"][:n] == r["eager_losses"],
              f"(q3 nccl) the captured ring steps equal the eager ones")
        check(np.abs(np.asarray(r["losses"][:n]) - want_losses).max()
              <= SEQ_MESH_TOL["loss"], "(q3 nccl) losses within the bound "
              "of the single-device Trainer")
    return {"per_rank": ranks}


def seq_two_tower(torch, mb, ops, optimizers, tmp) -> dict:
    """(q4) the ported example's main at its defaults; the two-tower at
    MovieLens-20M's counts, eager and graph bit-equal to the plain
    versions, exported and served over REST at another width."""
    from openembedding_tpu_torch.examples import two_tower_retrieval as ex
    from openembedding_tpu_torch.export import (StandaloneModel,
                                                export_standalone)
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_two_tower
    from openembedding_tpu_torch.serving import ServingClient, make_server
    total = {k: 0 for k in KERNELS}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = ex.main([])
    ran = ran_launches(ops.launch_counts(), [graph_record(out["step"])])
    _add(total, ran)
    losses = out["losses"]
    check(np.isfinite(losses).all() and losses[-1] < losses[0]
          and np.isfinite(out["scores"]).all(),
          f"(q4) the example trains ({losses[0]} -> {losses[-1]}) and "
          "serves finite scores")
    check(ran["gather_rows"] >= 2 * 60 and ran["fused_sparse_apply"] == 2 * 60,
          f"(q4) the example launched a gather and an apply a table a step "
          f"({ran})")
    rec = {"example": {"loss_first_last": [float(losses[0]),
                                           float(losses[-1])],
                       "seconds": time.perf_counter() - t0,
                       "launches": ran,
                       "scores_shape": list(out["scores"].shape)}}
    del out
    rng = np.random.default_rng(SEQ_SEED)
    batches = [ex.synthetic_histories(
        rng, TWO_TOWER_BATCH, TWO_TOWER["user_vocabulary"],
        TWO_TOWER["item_vocabulary"], ex.MAX_HIST, ex.MAX_TAGS)
        for _ in range(TWO_TOWER_STEPS)]
    model = make_two_tower(**TWO_TOWER)
    trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.1))
    state = trainer.init(batches[0])
    start = state.clone()
    state, losses, ref, ref_losses, launches, ms, plain_ms, cmp = \
        _seq_clone_run(torch, mb, ops, trainer, state, batches, "q4")
    _add(total, launches)
    check(launches["gather_rows"] == 2 * TWO_TOWER_STEPS
          and launches["fused_sparse_apply"] == 2 * TWO_TOWER_STEPS,
          f"(q4) one gather and one apply a table a step ({launches})")
    rec["ml20m"] = {"eager": {"ms_per_step": ms,
                              "plain_ms_per_step": plain_ms,
                              "launches": launches, **cmp},
                    "losses": losses.tolist()}
    gstate, driver, grec, gran = _seq_graph(
        torch, mb, ops, trainer, start, batches, ref, ref_losses, "q4")
    _add(total, gran)
    grec.update(profile_device(torch, lambda: driver(gstate, batches[-1]),
                               unit="step"))
    rec["ml20m"]["graph"] = grec
    export = os.path.join(tmp, "two_tower")
    export_standalone(state, model, export)
    query = {"user": [[11, 4], [200], [7, 8, 9], [138000, -1, 5]],
             "item": [[4, 11], [7], [20], [26000, 1]]}
    httpd = make_server(os.path.join(tmp, "registry-tt"), port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(f"http://127.0.0.1:{httpd.server_address[1]}",
                               timeout=300)
        client.create_model("two-tower-smoke", export)
        ops.reset_launch_counts()
        served = client.predict("two-tower-smoke", query)
        got = ops.launch_counts()
        _add(total, got)
        from openembedding_tpu_torch.serving import _pad_ragged_bucketed
        dense = {k: _pad_ragged_bucketed(v) for k, v in query.items()}
        want = StandaloneModel.load(export).predict(
            {"sparse": dense}).float().cpu().numpy()
        equal = bool(np.array_equal(served, want))
        rec["ml20m"]["rest"] = {"shape": list(served.shape),
                                "equal_in_process": equal,
                                "gathers": got["gather_rows"]}
        check(equal and served.shape == (4, 8) and got["gather_rows"] == 2,
              f"(q4) REST scores at widths 3/2 equal the in-process "
              f"predict ({rec['ml20m']['rest']})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        check(not thread.is_alive(), "the server thread stopped")
    rec["launches"] = total
    del trainer, state, ref, gstate, driver, start
    torch.cuda.empty_cache()
    return rec


def seq_variable(torch, mb, ops, optimizers) -> dict:
    """(q5) EmbeddingVariable on a 2^24 x 10 table: sparse_read ->
    push_gradients -> update_weights on 106,496 Zipfian ids, bit-equal to
    the same through the plain versions."""
    from openembedding_tpu_torch.embedding import EmbeddingSpec
    from openembedding_tpu_torch.variable import EmbeddingVariable
    spec = EmbeddingSpec(name="v", input_dim=VAR_ROWS, output_dim=VAR_DIM,
                         variable_id=0)
    var = EmbeddingVariable(spec, optimizers.Adagrad(learning_rate=0.05),
                            seed=SEQ_SEED)
    plain = EmbeddingVariable(spec, optimizers.Adagrad(learning_rate=0.05),
                              seed=SEQ_SEED)
    rng = np.random.default_rng(SEQ_SEED)
    ids = zipf_ids(rng, VAR_IDS, VAR_ROWS).astype(np.int64)
    grads = rng.normal(size=(VAR_IDS, VAR_DIM)).astype(np.float32)
    ids_t = torch.from_numpy(ids).cuda()
    grads_t = torch.from_numpy(grads).cuda()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = var.sparse_read(ids_t)
    var.push_gradients(ids_t, grads_t)
    var.update_weights()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    with ops.plain_versions():
        prows = plain.sparse_read(ids_t)
        plain.push_gradients(ids_t, grads_t)
        plain.update_weights()
    check(launches["gather_rows"] == 1 and launches["fused_sparse_apply"] == 1,
          f"(q5) one gather and one apply ({launches})")
    equal = {"rows": torch.equal(mb.bits(rows), mb.bits(prows)),
             "weights": torch.equal(mb.bits(var.state.weights),
                                    mb.bits(plain.state.weights)),
             "accum": torch.equal(mb.bits(var.state.slots["accum"]),
                                  mb.bits(plain.state.slots["accum"]))}
    check(all(equal.values()), f"(q5) bit-equal to the plain versions "
          f"({equal})")
    read_ms = mb.device_ms(lambda: var.read_only_pull(ids_t))
    rec = {"table": [VAR_ROWS, VAR_DIM], "ids": VAR_IDS,
           "bit_equal": equal, "read_push_update_ms": ms,
           "read_only_pull_device_ms": read_ms,
           "launches": {k: launches[k] for k in KERNELS}}
    del var, plain
    torch.cuda.empty_cache()
    return rec


def phase_seq(torch, mb, ops, optimizers, smi: str) -> dict:
    """The retrieval and sequence families: (q1) SASRec, (q2) BERT4Rec,
    (q3) SeqMeshTrainer on four staged ranks, (q4) the two-tower, (q5)
    EmbeddingVariable -> {kernel: launches of the phase}."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-seq-")
    total = {k: 0 for k in KERNELS}
    try:
        for key, fn in (("q1", lambda: seq_sasrec(torch, mb, ops, optimizers,
                                                  tmp)),
                        ("q2", lambda: seq_bert4rec(torch, mb, ops,
                                                    optimizers)),
                        ("q3", lambda: seq_mesh(torch, optimizers)),
                        ("q4", lambda: seq_two_tower(torch, mb, ops,
                                                     optimizers, tmp)),
                        ("q5", lambda: seq_variable(torch, mb, ops,
                                                    optimizers))):
            t1 = time.perf_counter()
            rec = fn()
            _add(total, rec["launches"])
            emit({"phase": "seq", key: rec,
                  "seconds": time.perf_counter() - t1, "card": smi})
        for k in ("gather_rows", "fused_sparse_apply"):
            check(total[k] > 0, f"the seq path launched {k}")
        emit({"phase": "seq", "launches": total, "card": smi,
              "wall_seconds": time.perf_counter() - t0})
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- obs: observability on the main path ---------------------------------------

OBS_STEPS = 40            # (o1) graph steps of each run; (o3) the watch's
OBS_TIMED_FROM = 5        # (o1) steps timed from here on
OBS_HALT_K = 5            # (o2) the NaN is planted after step k - 1
OBS_MEASURE_EVERY = 8     # (o3) one graph step in 8 measured
OBS_ENTRY_STEPS = 20      # (o4) one pass of the TSV a run
OBS_MESH = 4              # (o5) staged gloo ranks on the one card
OBS_MESH_K = 3            # (o5) the NaN label rides step k
OBS_PREDICTS = 32         # (o6) REST predicts of BATCH rows, each way
OBS_NORM_RTOL = 1e-5      # (o1) health.grad_norm vs the float64 norm


def _health(m_module) -> dict:
    return {k: v for k, v in m_module.report().items()
            if k.startswith("health.")}


def _obs_graph_run(torch, trainer, state, batches, record: bool) -> tuple:
    """`jit_train_step` over `batches` from `state`; with `record`, each
    step's stats folded through `record_step_stats` -> (state, losses, the
    health gauges after each step, wall ms a step from OBS_TIMED_FROM on,
    the driver)."""
    from openembedding_tpu_torch.utils import metrics as M
    step = trainer.jit_train_step()
    losses, health = [], []
    for i, b in enumerate(batches):
        if i == OBS_TIMED_FROM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss"].clone())
        if record:
            trainer.record_step_stats(m)
            health.append(_health(M))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - OBS_TIMED_FROM)
    return state, torch.stack(losses).cpu().numpy(), health, ms, step


def _float64_norms(torch, trainer, state, batch) -> tuple:
    """One eager sentinel step from `state` whose gradients are also summed
    in float64 -> (the recorded health summary, {source: float64 norm})."""
    seen = {}
    real = trainer._sentinel_stats

    def spy(loss, dense_grads, row_grads):
        seen["dense"] = float(torch.cat(
            [g.reshape(-1).double() for g in dense_grads.values()])
            .square().sum().sqrt())
        for name, g in row_grads.items():
            seen[name] = float(g.double().square().sum().sqrt())
        return real(loss, dense_grads, row_grads)
    trainer._sentinel_stats = spy
    try:
        state, m = trainer.train_step(state, batch)
        health = trainer.record_step_stats(m)
    finally:
        del trainer._sentinel_stats
    return health, seen


def obs_sentinel(torch, mb, ops, optimizers, model, start, batches) -> dict:
    """(o1) the sentinel changes nothing in the state; (o3) measure_every."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.utils import metrics as M
    opt = lambda: optimizers.Adagrad(learning_rate=0.05)  # noqa: E731
    total = {k: 0 for k in KERNELS}
    rec = {}
    runs = {}
    for key, kw, record in (("off", {}, False),
                            ("on_read", {"sentinel": True}, True)):
        M.reset_all()
        trainer = Trainer(model, opt(), **kw)
        ops.reset_launch_counts()
        state, losses, health, ms, step = _obs_graph_run(
            torch, trainer, start.clone(), batches, record)
        ran = ran_launches(ops.launch_counts(), [graph_record(step)])
        _add(total, ran)
        runs[key] = (trainer, state, losses, health, step)
        rec[key] = {"wall_ms_per_step": ms, "launches": ran,
                    "graph_launches": step.graph_launches}
    # the plain twin: eager steps through the plain versions, sentinel on
    M.reset_all()
    plain = Trainer(model, opt(), sentinel=True)
    pstate, plosses, phealth = start.clone(), [], []
    with ops.plain_versions():
        for b in batches:
            pstate, m = plain.train_step(pstate, b)
            plosses.append(m["loss"].clone())
            plain.record_step_stats(m)
            phealth.append(_health(M))
    plosses = torch.stack(plosses).cpu().numpy()
    off, on = runs["off"], runs["on_read"]
    cmp_on = _compare(torch, mb, on[1], on[2], off[1], off[2],
                      "o1_sentinel_on_vs_off")
    cmp_plain = _compare(torch, mb, pstate, plosses, off[1], off[2],
                         "o1_plain_sentinel_vs_off")
    check(on[3] == phealth and len(on[3]) == len(batches)
          and all(h for h in on[3]),
          "(o1) the health gauges of the kernel run equal the plain run's")
    check(on[4].graph_launches == off[4].graph_launches,
          f"(o1) the same launches a step with the sentinel on and off "
          f"({on[4].graph_launches} vs {off[4].graph_launches})")
    # float64 norms of one more step's gradients
    health, f64 = _float64_norms(torch, on[0], on[1].clone(), batches[0])
    errs = {k: abs(health["grad_norm"][k] - v) / v for k, v in f64.items()}
    check(set(errs) == set(health["grad_norm"])
          and max(errs.values()) <= OBS_NORM_RTOL,
          f"(o1) health.grad_norm within {OBS_NORM_RTOL} of float64 "
          f"({errs})")
    # costs: the read alone, the sentinel on without the read, device time
    tr, state, step = on[0], on[1], on[4]
    reads, walls = [], []
    for b in batches[:10]:
        state, m = step(state, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.record_step_stats(m)
        reads.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[OBS_TIMED_FROM:]:
        state, m = step(state, b)
    torch.cuda.synchronize()
    on_noread = ((time.perf_counter() - t0) * 1e3
                 / (len(batches) - OBS_TIMED_FROM))
    # (these measuring replays are left out of the phase's launches)
    prof_off = profile_device(
        torch, lambda: off[4](off[1], batches[-1]), calls=10, unit="step")
    prof_on = profile_device(
        torch, lambda: step(state, batches[-1]), calls=10, unit="step")
    rec.update({
        "losses_bit_equal_three_ways": True, **cmp_on, **cmp_plain,
        "health_bit_equal_kernel_vs_plain": True,
        "health_last": on[3][-1],
        "grad_norm_vs_float64_rel_err": errs,
        "read_ms_median": float(np.median(reads)), "read_ms": reads,
        "wall_ms_per_step_sentinel_on_no_read": on_noread,
        "device_ms_per_step_off":
            prof_off["profile_device_ms_per_step"],
        "device_ms_per_step_on":
            prof_on["profile_device_ms_per_step"],
        "profile_off": prof_off, "profile_on": prof_on})
    del runs, off, on, tr, state, step, pstate, plain
    torch.cuda.empty_cache()
    # (o3) measure_every over OBS_STEPS graph steps
    M.reset_all()
    trainer = Trainer(model, opt(), measure_every=OBS_MEASURE_EVERY)
    ops.reset_launch_counts()
    _, _, _, ms, step = _obs_graph_run(torch, trainer, start.clone(),
                                       batches, False)
    _add(total, ran_launches(ops.launch_counts(), [graph_record(step)]))
    watch = trainer._ensure_stepwatch()
    acc = M.Accumulator.get("trainer.step_ms", "hist")
    dev = M.Accumulator.get("trainer.step_device_ms", "hist")
    check(watch.samples == acc.count == OBS_STEPS // OBS_MEASURE_EVERY,
          f"(o3) {OBS_STEPS // OBS_MEASURE_EVERY} trainer.step_ms samples "
          f"({watch.samples}, {acc.count})")
    rec["o3"] = {"samples": acc.count,
                 "step_ms_p50": acc.quantile(0.5),
                 "step_device_ms_p50": dev.quantile(0.5),
                 "unsampled_wall_ms_per_step": ms,
                 "cuda_event_device_ms_per_step_o1":
                     rec["device_ms_per_step_off"]}
    rec["launches"] = total
    return rec


def _plant(torch, state, where: str, batch) -> dict:
    """A NaN in the state (a table row the batch pulls, the first dense
    weight) or in a copy of the batch's labels -> the batch to step on."""
    if where == "table":
        row = int(batch["sparse"]["categorical"].reshape(-1)[0])
        state.tables["categorical"].weights[row, 0] = float("nan")
    elif where == "dense":
        with torch.no_grad():
            next(state.dense.parameters()).view(-1)[0] = float("nan")
    else:
        batch = dict(batch, label=batch["label"].copy())
        batch["label"][7] = np.nan
    return batch


def obs_halt(torch, ops, optimizers, model, start, batches, tmp) -> dict:
    """(o2) halt_on_nonfinite stops at the planted step."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.utils import capsule, metrics as M
    from openembedding_tpu_torch.utils import trace as T
    total = {k: 0 for k in KERNELS}
    rec = {}
    want = {"table": "categorical", "dense": "dense", "loss": "loss"}
    for halt in (True, False):
        for where, source in want.items():
            M.reset_all()
            T.RECORDER.clear()
            caps = os.path.join(tmp, f"caps-{where}-{halt}")
            capsule.configure(caps, min_interval_s=0.0)
            trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05),
                              **({"halt_on_nonfinite": True} if halt
                                 else {"sentinel": True}))
            step = trainer.jit_train_step()
            state = start.clone()
            ops.reset_launch_counts()
            raised_at, sources, health = None, None, None
            try:
                for k in range(OBS_HALT_K + 1):
                    b = batches[k]
                    if k == OBS_HALT_K:
                        b = _plant(torch, state, where, b)
                    state, m = step(state, b)
                    health = trainer.record_step_stats(m)
                    check(k == OBS_HALT_K or not health["nonfinite"],
                          f"(o2) step {k} is clean")
            except M.NonFiniteError as e:
                raised_at, sources = k, dict(e.sources)
            _add(total, ran_launches(ops.launch_counts(),
                                     [graph_record(step)]))
            key = f"{where}_{'halt' if halt else 'record'}"
            events = [(e.group, e.name) for e in T.RECORDER.events()]
            if halt:
                check(raised_at == OBS_HALT_K and source in sources
                      and set(sources) == {"categorical", "dense", "loss"},
                      f"(o2 {where}) NonFiniteError at step {OBS_HALT_K} "
                      f"naming {source} ({raised_at}, {sources})")
                files = sorted(os.listdir(caps))
                check(len(files) == 1, f"(o2 {where}) one capsule {files}")
                cap = capsule.load(os.path.join(caps, files[0]))
                check(cap["reason"] == "nonfinite"
                      and cap["attrs"]["offenders"],
                      f"(o2 {where}) the capsule loads")
                rec[key] = {"raised_at": raised_at, "sources": sources,
                            "capsule_flight_items": len(cap["flight"])}
            else:
                check(raised_at is None and health["nonfinite"]
                      and source in health["nonfinite"],
                      f"(o2 {where}) halt off: recorded, not raised "
                      f"({health})")
                rec[key] = {"nonfinite": health["nonfinite"],
                            "nonfinite_total":
                                M.report()["health.nonfinite_total"]}
            check(("health", "nonfinite") in events,
                  f"(o2 {key}) the flight recorder holds health/nonfinite")
            del trainer, step, state
    capsule.configure(None)
    torch.cuda.empty_cache()
    rec["launches"] = total
    return rec


def obs_entry(torch, ops, tsv: str, tmp: str) -> dict:
    """(o4) the entry point's six flags against the same run without."""
    from openembedding_tpu_torch.examples import criteo_deepctr as ex
    from openembedding_tpu_torch.utils import metrics as M, sketch
    from openembedding_tpu_torch.utils import trace as T
    base = ["--data", tsv, "--vocabulary", str(VOCAB), "--batch-size",
            str(BATCH), "--steps", str(OBS_ENTRY_STEPS)]
    log = os.path.join(tmp, "m.jsonl")
    dump = os.path.join(tmp, "t.json")
    prof = os.path.join(tmp, "prof")
    flags = ["--report-interval", "1", "--metrics-log", log,
             "--flight-recorder", "4096", "--trace-dump", dump,
             "--skew-report", "--profile", prof]
    total = {k: 0 for k in KERNELS}
    kept = []
    observe = sketch.MONITOR.observe

    def counting(table, ids):
        ok = observe(table, ids)
        if ok:
            kept.append(np.asarray(ids).reshape(-1))
        return ok
    rec = {}
    for key, argv in (("plain", base), ("skew_only", base + ["--skew-report"]),
                      ("flags", base + flags)):
        M.reset_all()
        T.RECORDER.clear()
        sketch.MONITOR.reset()
        kept.clear()
        with mock.patch.object(sketch.MONITOR, "observe", counting):
            out, ran = _run_main(ops, ex, argv)
        _add(total, ran)
        rec[key] = {"steady_examples_per_s": out["steady_examples_per_s"],
                    "losses": out["losses"],
                    "dropped_batches": M.report().get(
                        "skew.dropped_batches", 0.0),
                    "kept_batches": len(kept)}
        if key != "plain":
            sketch.MONITOR.drain()
            ids = np.concatenate(kept) if kept else np.zeros(0, np.int64)
            true = dict(zip(*np.unique(ids[ids >= 0], return_counts=True)))
            top = sketch.MONITOR.sketch("categorical").topk() if kept else []
            bad = [(h, e, r, int(true.get(h, 0))) for h, e, r in top
                   if not e - r <= true.get(h, 0) <= e]
            check(not bad, f"(o4 {key}) every listed id within its bound "
                  f"({bad[:4]})")
            rec[key]["listed_ids"] = len(top)
            sketch.MONITOR.close()
    for key in ("skew_only", "flags"):
        check(np.array_equal(rec[key]["losses"].view(np.int32),
                             rec["plain"]["losses"].view(np.int32)),
              f"(o4 {key}) losses bit-equal to the run without the flags")
    records = [json.loads(x) for x in open(log)]
    check(records and records[-1]["metrics"].get("train.step.ms", 0) > 0,
          "(o4) the JSONL parses and holds the loop's spans")
    events = json.load(open(dump))["traceEvents"]
    names = {e["name"] for e in events}
    check({"trainer.pull", "trainer.compute", "trainer.apply",
           "trainer.capture", "trainer.replay", "train.step"} <= names,
          f"(o4) the Chrome trace holds the trainer spans ({sorted(names)})")
    ptrace = json.load(open(os.path.join(prof, "trace.json")))
    kernels = sum(1 for e in ptrace["traceEvents"]
                  if e.get("cat") == "kernel")
    check(kernels > 0, "(o4) the profiler's trace loads and holds kernels")
    for r in rec.values():
        r["losses"] = r["losses"].tolist()
    rec.update({"jsonl_records": len(records), "trace_events": len(events),
                "profiler_kernel_events": kernels,
                "profiler_trace_bytes": os.path.getsize(
                    os.path.join(prof, "trace.json")),
                "launches": total})
    return rec


def obs_mesh_rank(mesh):
    """(o5) one staged rank: the int8 wire with error feedback and
    halt_on_nonfinite; the health gauges after each clean step; the step
    that raised; the staged bytes a step with the sentinel on and off."""
    import torch
    from openembedding_tpu_torch import data, ops, optimizers
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    from openembedding_tpu_torch.utils import metrics as M
    torch.backends.cuda.matmul.allow_tf32 = False
    check(mesh.staged and mesh.size == OBS_MESH, f"a staged mesh {mesh}")
    globals_ = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                          seed=TRAIN_SEED,
                                          steps=OBS_MESH_K + 1))
    nan_batch = dict(globals_[OBS_MESH_K],
                     label=globals_[OBS_MESH_K]["label"].copy())
    nan_batch["label"][3] = np.nan   # rank 0's rows only
    globals_[OBS_MESH_K] = nan_batch
    batches = [local_batch(b, mesh) for b in globals_]
    out = {"rank": mesh.rank, "health": [], "halt": None}
    ops.reset_launch_counts()
    for sentinel in (False, True):
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)
        trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                              mesh=mesh, wire="int8", error_feedback=True,
                              halt_on_nonfinite=sentinel)
        state = trainer.init(batches[0])
        staged = []
        for k, b in enumerate(batches if sentinel else batches[:2]):
            M.reset_all()
            before = mesh.staged_bytes
            state, m = trainer.train_step(state, b)
            torch.cuda.synchronize()
            staged.append(mesh.staged_bytes - before)
            try:
                h = trainer.record_step_stats(m)
            except M.NonFiniteError as e:
                out["halt"] = [k, dict(e.sources)]
                break
            if sentinel:
                out["health"].append({key: v for key, v in
                                      M.report().items()
                                      if key.startswith("health.")})
                check(h["sentinel"], "(o5) the sentinel's stats arrived")
        out["staged_bytes_per_step_" + ("on" if sentinel else "off")] = \
            staged[1]
        out["exchange_cost_bytes_per_step"] = \
            trainer.last_wire_cost["bytes_per_step"]
        del trainer, state
        torch.cuda.empty_cache()
    out["launches"] = ops.launch_counts()
    return out


def obs_mesh(torch) -> dict:
    from openembedding_tpu_torch.parallel.multihost import run_local
    t0 = time.perf_counter()
    ranks = run_local(obs_mesh_rank, OBS_MESH, backend="gloo",
                      device="cuda", timeout_s=600, threads=0)
    wall = time.perf_counter() - t0
    total = {k: 0 for k in KERNELS}
    for r in ranks:
        check(r["health"] == ranks[0]["health"]
              and len(r["health"]) == OBS_MESH_K,
              f"(o5) rank {r['rank']}'s health equals rank 0's")
        check(r["halt"] is not None and r["halt"][0] == OBS_MESH_K
              and r["halt"][1] == ranks[0]["halt"][1]
              and {"loss", "dense", "categorical"} <= set(r["halt"][1]),
              f"(o5) rank {r['rank']} raised at step {OBS_MESH_K} "
              f"({r['halt']})")
        _add(total, r["launches"])
    h = ranks[0]["health"]
    for key in ('health.grad_norm{table="categorical"}',
                'health.quant_err_rel{table="categorical"}',
                'health.ef_abs_mean{table="categorical"}'):
        check(all(key in x for x in h[1:]), f"(o5) {key} published")
    return {"wall_seconds": wall, "health": h, "halt": ranks[0]["halt"],
            "staged_bytes_per_step_on": [r["staged_bytes_per_step_on"]
                                         for r in ranks],
            "staged_bytes_per_step_off": [r["staged_bytes_per_step_off"]
                                          for r in ranks],
            "exchange_cost_bytes_per_step":
                ranks[0]["exchange_cost_bytes_per_step"],
            "launches": total}


def _http(url, body=None):
    import urllib.request
    req = urllib.request.Request(url, data=body,
                                 method="POST" if body else "GET")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read().decode()


def obs_serving(torch, ops, model, state, tmp) -> dict:
    """(o6) the REST telemetry over the exported flagship."""
    from openembedding_tpu_torch import data
    from openembedding_tpu_torch.export import export_standalone
    from openembedding_tpu_torch.serving import ServingClient, make_server
    from openembedding_tpu_torch.utils import metrics as M, sketch
    from openembedding_tpu_torch.utils import trace as T
    M.reset_all()
    T.RECORDER.clear()
    sketch.MONITOR.reset()
    export = os.path.join(tmp, "export")
    export_standalone(state, model, export)
    servers = []
    for name, peers in (("b", None), ("a", "b")):
        httpd = make_server(os.path.join(tmp, f"reg-{name}"), port=0,
                            peers=[servers[0][1]] if peers else None)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        servers.append((httpd, f"http://127.0.0.1:{httpd.server_address[1]}",
                        th))
    url = servers[1][1]
    total = {k: 0 for k in KERNELS}
    rec = {}
    try:
        client = ServingClient(url, timeout=300)
        client.create_model(SIGN, export)
        batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                             seed=TRAIN_SEED + 11,
                                             steps=OBS_PREDICTS))
        sent = 0
        for scrape in (False, True):
            ms, rids = [], []
            ops.reset_launch_counts()
            for i, b in enumerate(batches):
                rid = f"obs-{int(scrape)}-{i}"
                rids.append(rid)
                t0 = time.perf_counter()
                with T.request(rid):
                    got = client.predict(SIGN, b["sparse"], b["dense"])
                ms.append((time.perf_counter() - t0) * 1e3)
                check(got.shape == (BATCH,) and np.isfinite(got).all(),
                      "(o6) finite logits")
                sent += int((b["sparse"]["categorical"] >= 0).sum())
                if scrape:
                    code, _ = _http(f"{url}/metrics")
                    check(code == 200, "(o6) /metrics between predicts")
            launched = ops.launch_counts()
            _add(total, launched)
            rec["p50_ms_" + ("with_scrape" if scrape else "plain")] = \
                float(np.median(ms))
            if not scrape:
                code, text = _http(f"{url}/metrics")
                parsed = M.parse_prometheus(text)
                n = [v for name, lab, v in parsed["samples"]
                     if name == "oetpu_serving_predict_ms_count"
                     and lab.get("model") == SIGN]
                check(n == [float(OBS_PREDICTS)],
                      f"(o6) /metrics counts {OBS_PREDICTS} predicts ({n})")
                code, body = _http(f"{url}/tracez?n=100000")
                spans = json.loads(body)["spans"]
                seen = sorted(s["request_id"] for s in spans
                              if (s["group"], s["name"])
                              == ("serving", "predict"))
                check(seen == sorted(rids),
                      f"(o6) /tracez holds {OBS_PREDICTS} serving/predict "
                      "spans with the client's request ids")
                rec["gathers_per_predict"] = launched["gather_rows"] \
                    / OBS_PREDICTS
        for route in ("statusz", "sloz", "historz", "timelinez"):
            code, _ = _http(f"{url}/{route}")
            check(code == 200, f"(o6) /{route} answers 200")
        code, text = _http(f"{url}/fleetz")
        fleet = M.parse_prometheus(text)
        node = M.parse_prometheus(_http(f"{servers[0][1]}/metrics")[1])
        http_fleet = [v for name, lab, v in fleet["samples"]
                      if name == "oetpu_serving_predict_ms_count"
                      and lab.get("model") == SIGN]
        http_node = [v for name, lab, v in node["samples"]
                     if name == "oetpu_serving_predict_ms_count"
                     and lab.get("model") == SIGN]
        # one process holds both nodes' registry: each counter twice
        check(text.startswith("# fleet: 2 node(s)")
              and http_fleet == [2 * http_node[0]],
              f"(o6) /fleetz sums both nodes ({http_fleet}, {http_node})")
        sketch.MONITOR.drain()
        dropped = M.report().get("skew.dropped_batches", 0.0)
        seen_ids = sketch.MONITOR.sketch("categorical").total
        check(seen_ids == sent if not dropped else 0 < seen_ids < sent,
              f"(o6) the sketch saw the predicted ids ({seen_ids} of "
              f"{sent}, {dropped} batches dropped)")
        rec.update({"sketch_ids": seen_ids, "sent_ids": sent,
                    "skew_dropped_batches": dropped,
                    "fleet_predict_count": http_fleet[0]})
    finally:
        for httpd, _u, th in servers:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=60)
        sketch.MONITOR.close()
    rec["launches"] = total
    return rec


def phase_obs(torch, mb, ops, data, optimizers, tsv: str, smi: str) -> dict:
    """Observability on the main path: (o1)+(o3) the sentinel and the step
    watch, (o2) the halt, (o4) the entry point's flags, (o5) four staged
    ranks, (o6) the REST telemetry -> {kernel: launches of the phase}."""
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-obs-")
    total = {k: 0 for k in KERNELS}
    try:
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)
        batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                             seed=TRAIN_SEED,
                                             steps=OBS_STEPS))
        start = Trainer(model, optimizers.Adagrad(
            learning_rate=0.05)).init(batches[0])
        parts = (
            ("o1", lambda: obs_sentinel(torch, mb, ops, optimizers, model,
                                        start, batches)),
            ("o2", lambda: obs_halt(torch, ops, optimizers, model, start,
                                    batches, tmp)),
            ("o4", lambda: obs_entry(torch, ops, tsv, tmp)),
            ("o5", lambda: obs_mesh(torch)),
            ("o6", lambda: obs_serving(torch, ops, model, start, tmp)))
        for key, fn in parts:
            t1 = time.perf_counter()
            rec = fn()
            _add(total, rec["launches"])
            emit({"phase": "obs", key: rec,
                  "seconds": time.perf_counter() - t1, "card": smi})
            torch.cuda.empty_cache()
        for k in ("gather_rows", "fused_sparse_apply"):
            check(total[k] > 0, f"the obs path launched {k}")
        emit({"phase": "obs", "launches": total, "card": smi,
              "wall_seconds": time.perf_counter() - t0})
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


AUTO_RANKS = 4            # staged gloo ranks on the one card
AUTO_STEPS = 30           # steps a phase of the drift (bench.py: 30)
AUTO_POOL = 64            # the heavy pool's ids
AUTO_SHARE = 0.6          # the pool's share of the positions
AUTO_HOT = 32             # the hot budget, in rows of the 10-wide table
AUTO_MIG = 64             # the policy's annex rows
AUTO_SEED = 13            # bench.py's stream seed


def drift_stream(S: int, steps: int = AUTO_STEPS, seed: int = AUTO_SEED):
    """`bench.py`'s `case_placement` stream at full width: global batches
    of BATCH x 26 ids uniform over VOCAB, AUTO_SHARE of the positions
    from a 1/(r+1)-weighted pool homed on shard S-1, then on shard 1."""
    rng = np.random.default_rng(seed)
    pre = (np.arange(AUTO_POOL) * S + S - 1).astype(np.int64)
    post = (np.arange(AUTO_POOL) * S + 1).astype(np.int64)
    w = 1.0 / (np.arange(AUTO_POOL) + 1.0)
    w /= w.sum()
    out = []
    for i in range(2 * steps):
        pool = pre if i < steps else post
        ids = rng.integers(0, VOCAB, (BATCH, 26))
        mask = rng.random((BATCH, 26)) < AUTO_SHARE
        ids[mask] = pool[rng.choice(AUTO_POOL, size=int(mask.sum()), p=w)]
        out.append({
            "sparse": {"categorical": ids.astype(np.int32)},
            "dense": rng.normal(size=(BATCH, 13)).astype(np.float32),
            "label": rng.integers(0, 2, (BATCH,)).astype(np.float32)})
    return out


def _auto_controller(trainer, mon, ids):
    from openembedding_tpu_torch.placement import (PlacementController,
                                                   PlacementPolicy)
    from openembedding_tpu_torch.placement.policy import row_bytes
    policy = PlacementPolicy(AUTO_HOT * row_bytes(DIM + 1), mig_rows=AUTO_MIG,
                             refresh_cooldown_steps=3, imbalance_target=1.05)
    ctrl = PlacementController(trainer, policy, monitor=mon,
                               interval_steps=3)
    for x in ids[:3]:
        mon.observe("categorical", x)
    return ctrl


def _auto_run(torch, trainer, state, batches, ids, controlled: bool):
    """The drift stream's eager steps on this rank, the controller on or
    off; every step's stats read (`record_step_stats`: the controller's
    shard loads). -> (state, record)."""
    from openembedding_tpu_torch.utils import metrics as M
    from openembedding_tpu_torch.utils.sketch import SkewMonitor
    with M._LOCK:   # each run reads its own shard loads (bench.py's too)
        M._REGISTRY.clear()
    mon = SkewMonitor(k=256, sync=True, decay=0.9)
    ctrl = _auto_controller(trainer, mon, ids) if controlled else None
    rec = {"losses": [], "imbalance": [], "hit": [], "installed": [],
           "status": [], "step_ms": [], "feed_ms": [], "train_ms": [],
           "on_step_ms": []}
    if ctrl is not None:
        epoch = trainer.graph_epoch
        state = ctrl.prime(state)
        rec["prime_epoch_moves"] = trainer.graph_epoch - epoch
        rec["prime_hot_rows"] = dict(trainer.hot_rows)
        rec["prime_mig_rows"] = dict(trainer.mig_rows)
        ptrs = [t.data_ptr() for t in state.tables["categorical"].tensors()]
        epoch = trainer.graph_epoch
    torch.cuda.synchronize()
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        if ctrl is not None:
            mon.observe("categorical", ids[i])
        t1 = time.perf_counter()
        state, m = trainer.train_step(state, b)
        trainer.record_step_stats(m)    # one copy: the step is done
        t2 = time.perf_counter()
        if ctrl is not None:
            state = ctrl.on_step(state, step=i + 1)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        st = m["stats"]
        pos = st["categorical/shard_positions"].double().cpu().numpy()
        rec["losses"].append(float(m["loss"]))
        rec["imbalance"].append(float(pos.max() / pos.mean()))
        if "categorical/hot_hits" in st:
            rec["hit"].append(float(st["categorical/hot_hits"])
                              / float(st["categorical/pull_indices"]))
        rec["step_ms"].append((t3 - t0) * 1e3)
        rec["feed_ms"].append((t1 - t0) * 1e3)
        rec["train_ms"].append((t2 - t1) * 1e3)
        rec["on_step_ms"].append((t3 - t2) * 1e3)
        if ctrl is not None:
            ts = state.tables["categorical"]
            rec["installed"].append([
                trainer._np_id_list(ts.hot.ids).tolist(),
                trainer._np_id_list(ts.mig.ids).tolist(),
                ts.mig.owners.cpu().numpy().tolist()])
            rec["status"].append(ctrl.status())
    if ctrl is not None:
        rec["graph_epoch_moved"] = trainer.graph_epoch != epoch
        rec["tensors_rebound"] = ptrs != [
            t.data_ptr() for t in state.tables["categorical"].tensors()]
        rec["render"] = ctrl.render_text()
    return state, rec


def _memory_check(trainer, state, what: str) -> dict:
    """`publish_memory`: analytic == measured on every component both
    price -> the ledger's numbers and the allocator's."""
    from openembedding_tpu_torch.utils import metrics as M
    model = trainer.publish_memory(state)
    a, m = model["analytic"], model["measured"]
    unequal = {k: (a[k], m[k]) for k in set(a) & set(m) if a[k] != m[k]}
    check(set(a) == set(m) and not unequal,
          f"(placement) {what}: analytic == measured ({unequal}, "
          f"{set(a) ^ set(m)})")
    rep = M.report()
    return {"components": m, "device_total_bytes": model[
        "device_total_bytes"], "hbm_used": rep.get("memory.hbm_used"),
        "hbm_limit": rep.get("memory.hbm_limit"),
        "model_drift": rep.get("memory.model_drift"),
        "headroom_ratio": rep.get("memory.headroom_ratio")}


def placement_auto_rank(mesh):
    """One staged rank of the placement phase (see the module docstring)."""
    import torch
    from openembedding_tpu_torch import ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    from openembedding_tpu_torch.utils import memwatch, trace
    from openembedding_tpu_torch.utils.sketch import SkewMonitor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S = mesh.size
    check(mesh.staged and S == AUTO_RANKS, f"a staged mesh {mesh}")
    globals_ = drift_stream(S)
    ids = [b["sparse"]["categorical"] for b in globals_]
    batches = [local_batch(b, mesh) for b in globals_]
    del globals_

    def trainer_of():
        return MeshTrainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                           optimizers.Adagrad(learning_rate=0.05), mesh=mesh)
    out = {"rank": mesh.rank}
    trainer = trainer_of()
    state = trainer.init(batches[0])
    start = state.clone()
    # a prime under a budget too small for the delta keeps the sizes
    # (before any device sample: a card's measured memory outranks a budget)
    memwatch.WATCH.configure(budget_bytes=1)
    tr_rej = trainer_of()
    ctrl = _auto_controller(tr_rej, SkewMonitor(k=256, sync=True,
                                                decay=0.9), ids)
    epoch = tr_rej.graph_epoch
    same = ctrl.prime(state)
    rejected = [e for e in trace.RECORDER.tail(100000)
                if getattr(e, "group", None) == "placement"
                and e.name == "prime_rejected"]
    out["prime_rejected"] = {
        "hot_rows": tr_rej.hot_rows, "mig_rows": tr_rej.mig_rows,
        "events": len(rejected), "epoch_moved": tr_rej.graph_epoch != epoch,
        "delta_bytes": rejected[-1].attrs["delta_bytes"] if rejected
        else None}
    check(same is state and not tr_rej.hot_rows and not tr_rej.mig_rows
          and rejected and state.tables["categorical"].hot is None
          and tr_rej.graph_epoch == epoch,
          f"(placement) a rejected prime keeps the sizes "
          f"({out['prime_rejected']})")
    del tr_rej, ctrl
    memwatch.WATCH.configure(budget_bytes=None)
    out["memory_init"] = _memory_check(trainer, state, "after init")

    # the controller on, through the kernels: the counts set to 0 just
    # before and read just after
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, on = _auto_run(torch, trainer, state, batches, ids, True)
    torch.cuda.synchronize()
    on["wall_seconds"] = time.perf_counter() - t0
    out["launches"] = _mesh_launches(ops.launch_counts())
    out["memory_primed"] = _memory_check(trainer, state, "after the run")
    check(on["prime_epoch_moves"] == 1 and not on["graph_epoch_moved"]
          and not on["tensors_rebound"],
          "(placement) prime moves graph_epoch once, nothing after it "
          "rebinds a tensor")
    # the same steps through the plain versions, from the same state
    plain_trainer = trainer_of()
    with ops.plain_versions():
        ref, plain = _auto_run(torch, plain_trainer, start.clone(), batches,
                               ids, True)
    check(plain["installed"] == on["installed"]
          and plain["status"] == on["status"],
          "(placement) the plain run made the same decisions")
    out["vs_plain"] = _compare(
        torch, mb, state, np.asarray(on["losses"], np.float32), ref,
        np.asarray(plain["losses"], np.float32), "placement_vs_plain")
    del ref, plain_trainer, state
    torch.cuda.empty_cache()
    # the controller off, on the same batches from the same state
    off_trainer = trainer_of()
    ops.reset_launch_counts()
    _, off = _auto_run(torch, off_trainer, start, batches, ids, False)
    out["launches_off"] = _mesh_launches(ops.launch_counts())
    out["on"], out["off"] = on, off
    return out


def _phase_mean(xs, lo, hi):
    third = max((hi - lo) // 3, 1)
    return float(np.mean(xs[hi - third:hi]))


def phase_placement(torch, smi: str) -> dict:
    """Self-driving placement on four staged ranks -> {kernel: launches of
    the controller-on run}."""
    from openembedding_tpu_torch.parallel.multihost import run_local
    t0 = time.perf_counter()
    ranks = run_local(placement_auto_rank, AUTO_RANKS, backend="gloo",
                      device="cuda", timeout_s=900, threads=0)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks[1:]:
        for run in ("on", "off"):
            check(r[run]["losses"] == r0[run]["losses"],
                  f"(placement) rank {r['rank']}'s {run} losses equal "
                  "rank 0's")
        check(r["on"]["installed"] == r0["on"]["installed"]
              and r["on"]["status"] == r0["on"]["status"]
              and r["on"]["render"] == r0["on"]["render"],
              f"(placement) rank {r['rank']} installed rank 0's sets and "
              "moves and reports its status")
    total = {k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
    for k in ("gather_rows", "fused_sparse_apply"):
        check(total[k] > 0, f"the placement path launched {k}")
    n = AUTO_STEPS
    summary = {}
    for run in ("on", "off"):
        rec = r0[run]
        summary[run] = {
            "imbalance_pre_drift": _phase_mean(rec["imbalance"], 0, n),
            "imbalance_post_drift": _phase_mean(rec["imbalance"], n, 2 * n),
            "hit_ratio_final": (_phase_mean(rec["hit"], n, 2 * n)
                                if rec["hit"] else None),
            "ms_per_step_median": float(np.median(rec["step_ms"][1:])),
            "ms_per_step_mean": float(np.mean(rec["step_ms"][1:])),
            "feed_ms_median": float(np.median(rec["feed_ms"][1:])),
            "train_ms_median": float(np.median(rec["train_ms"][1:])),
            "on_step_ms_median": float(np.median(rec["on_step_ms"][1:])),
            "on_step_ms_max": float(np.max(rec["on_step_ms"][1:]))}
    for run, key in (("on", "launches"), ("off", "launches_off")):
        summary[run]["launches"] = {k: sum(r[key][k] for r in ranks)
                                    for k in KERNELS}
    st = r0["on"]["status"][-1]
    summary["on"].update(
        refreshes=sorted({s["last_refresh_step"]["categorical"]
                          for s in r0["on"]["status"]}),
        migrations=st["migrations_applied"], decisions=st["decisions"],
        hot_rows=r0["on"]["prime_hot_rows"],
        mig_rows=r0["on"]["prime_mig_rows"])
    check(summary["on"]["imbalance_post_drift"]
          < summary["off"]["imbalance_post_drift"],
          f"(placement) the controller flattens the post-drift load "
          f"({summary})")
    rec = {"phase": "placement", "card": smi, "ranks": AUTO_RANKS,
           "steps": 2 * n, "summary": summary, "launches": total,
           "launches_by_rank": [r["launches"] for r in ranks],
           "prime_rejected": r0["prime_rejected"],
           "memory_init": [r["memory_init"] for r in ranks],
           "memory_primed": [r["memory_primed"] for r in ranks],
           "vs_plain": r0["vs_plain"], "render": r0["on"]["render"],
           "imbalance_on": r0["on"]["imbalance"],
           "imbalance_off": r0["off"]["imbalance"],
           "hit_on": r0["on"]["hit"], "losses_on": r0["on"]["losses"],
           "wall_seconds": wall}
    emit(rec)
    return total


SYNC_SIGN = "deepfm-sync-0"
SYNC_DELTAS = 6           # deltas after the base (bench.py case_sync: 3)
SYNC_FAULT = 3            # the delta whose payload the fault truncates
SYNC_HAMMERS = 4          # client threads predicting across the swaps
SYNC_HAMMER_ROWS = 1024   # rows a hammer request
SYNC_REST = 10            # REST predicts of 4096 rows a p50
SYNC_PAGE = 1 << 20       # restore_from_peer's page, rows


class _Hammer:
    """Client threads posting predicts through REST until stopped; `paused`
    holds them off (no request in flight) while the plain versions are
    swapped in for a comparison."""

    def __init__(self, url, batch, threads, rows, sign=SYNC_SIGN):
        self.sign = sign
        self.go = threading.Event()
        self.go.set()
        self.done = threading.Event()
        self.cv = threading.Condition()
        self.inflight = 0
        self.answered = 0
        self.failures = []
        self.threads = [threading.Thread(
            target=self._run, args=(url, batch, i * rows, rows), daemon=True)
            for i in range(threads)]
        for t in self.threads:
            t.start()

    def _run(self, url, batch, lo, rows):
        from openembedding_tpu_torch.serving import ServingClient
        client = ServingClient(url, timeout=300)
        sparse = {k: v[lo:lo + rows] for k, v in batch["sparse"].items()}
        dense = batch["dense"][lo:lo + rows]
        while not self.done.is_set():
            self.go.wait(timeout=0.1)
            with self.cv:
                if not self.go.is_set() or self.done.is_set():
                    continue
                self.inflight += 1
            try:
                got = client.predict(self.sign, sparse, dense)
                if got.shape != (rows,) or not np.isfinite(got).all():
                    raise ValueError(f"logits of shape {got.shape}")
                with self.cv:
                    self.answered += 1
            except Exception as e:  # noqa: BLE001 - counted as a failure
                self.failures.append(repr(e))
            finally:
                with self.cv:
                    self.inflight -= 1
                    self.cv.notify_all()

    def pause(self):
        self.go.clear()
        with self.cv:
            self.cv.wait_for(lambda: self.inflight == 0)

    def stop(self):
        self.done.set()
        self.go.set()
        for t in self.threads:
            t.join(timeout=300)


def _serve(make_server, registry, **kw):
    httpd = make_server(registry, port=0, **kw)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, th, f"http://127.0.0.1:{httpd.server_address[1]}"


def _rest_p50(client, batch, n=SYNC_REST, sign=SYNC_SIGN) -> float:
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        got = client.predict(sign, batch["sparse"], batch["dense"])
        ms.append((time.perf_counter() - t0) * 1e3)
        check(got.shape == (BATCH,) and np.isfinite(got).all(),
              "sync: finite REST logits")
    return float(np.median(ms))


def phase_sync(torch, mb, ops, data, optimizers, smi: str) -> int:
    """Online sync and live replicas at full width -> {kernel: launches of
    the phase}. See the module docstring, item 18."""
    from openembedding_tpu_torch.export import (StandaloneModel,
                                                export_standalone)
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.ops import wire
    from openembedding_tpu_torch.persist import (IncrementalPersister,
                                                 PersistPolicy,
                                                 _load_delta_table,
                                                 list_deltas)
    from openembedding_tpu_torch.serving import (ModelManager, ModelRegistry,
                                                 ServingClient, make_server,
                                                 restore_from_peer)
    from openembedding_tpu_torch.sync import FaultInjector, SyncSubscriber
    from openembedding_tpu_torch.utils import metrics as M

    class Truncate(FaultInjector):
        def payload(self, step, payload):
            name, (ids, rows) = next(iter(payload["tables"].items()))
            payload["tables"][name] = (ids, rows[:-1])
            return payload

    excluded = {k: 0 for k in KERNELS}

    @contextlib.contextmanager
    def uncounted():
        """Launches of a check (the hammer paused, nothing else running)
        are taken out of the path's counts."""
        before = ops.launch_counts()
        yield
        after = ops.launch_counts()
        for k in excluded:
            excluded[k] += after[k] - before[k]

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-sync-")
    servers, hammer, p, sub = [], None, None, None
    rec = {"card": smi}
    M.reset_all()
    try:
        batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                             seed=TRAIN_SEED + 17,
                                             steps=SYNC_DELTAS + 1))
        # the first training batch: its ids' rows move in later deltas
        probe = {k: batches[0][k] for k in ("sparse", "dense")}
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)
        trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
        state = trainer.init(batches[0])
        step = trainer.jit_train_step()
        root = os.path.join(tmp, "persist")
        base = os.path.join(tmp, "base")

        ops.reset_launch_counts()  # the path's run: counts read just after
        p = IncrementalPersister(trainer, model, root, window=2,
                                 policy=PersistPolicy(every_steps=1),
                                 full_every=100)
        state, _ = step(state, batches[0])
        p.maybe_persist(state, batch=batches[0])
        p.wait()
        export_standalone(state, model, base, model_sign=SYNC_SIGN)
        pub, _, pub_url = _serve(make_server, os.path.join(tmp, "reg-pub"),
                                 publish={SYNC_SIGN: root})
        servers.append(pub)
        srv, _, url = _serve(make_server, os.path.join(tmp, "reg-srv"),
                             batch_window_ms=2.0, max_batch=BATCH)
        servers.append(srv)
        client = ServingClient(url, timeout=300)
        client.create_model(SYNC_SIGN, base)
        sub = SyncSubscriber(srv.manager, SYNC_SIGN, pub_url)
        check(sub.poll() == 0 and sub.version == 1,
              f"sync: the subscriber negotiated the base ({sub.status()})")
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()

        hammer = _Hammer(url, probe, SYNC_HAMMERS, SYNC_HAMMER_ROWS)
        b0 = M.Accumulator.get("serving.predict_batches").value()
        r0 = M.Accumulator.get("serving.predict_requests").value()
        hops, poll_ms, fault, prev = [], [], None, None
        for i, b in enumerate(batches[1:], start=2):
            state, _ = step(state, b)
            p.maybe_persist(state, batch=b)
            p.wait()
            old = srv.manager.find_model(SYNC_SIGN)
            if i == SYNC_FAULT:
                hammer.pause()
                with uncounted():
                    before = old.predict(probe)
                hammer.go.set()
                rb = M.Accumulator.get("sync.rollbacks").value()
                sub.faults = Truncate()
                check(sub.poll() == 0 and sub.state == "DEGRADED",
                      f"sync: a torn delta degrades ({sub.status()})")
                now = srv.manager.find_model(SYNC_SIGN)
                hammer.pause()
                with uncounted():
                    same = torch.equal(now.predict(probe), before)
                hammer.go.set()
                check(now is old and same
                      and M.Accumulator.get("sync.rollbacks").value()
                      == rb + 1, "sync: the node kept the last good "
                      "servable and counted the rollback")
                del now, before
                fault = {"step": i, "reason": sub.last_error,
                         "state": sub.state}
                sub.faults = None
            t0 = time.perf_counter()
            applied = sub.poll()
            poll_ms.append((time.perf_counter() - t0) * 1e3)
            check(applied == 1 and sub.version == i and sub.state == "IDLE",
                  f"sync: delta {i} applied ({sub.status()})")
            hops.append(sub.status()["last_hops"]["hops"])
            servable = srv.manager.find_model(SYNC_SIGN)
            check(servable is not old and servable.step == i,
                  f"sync: servable swapped to step {i}")
            oracle_dir = os.path.join(tmp, "oracle")
            export_standalone(state, model, oracle_dir)
            oracle = StandaloneModel.load(oracle_dir)
            hammer.pause()
            with uncounted():
                got = servable.predict(probe)
                want = oracle.predict(probe)
                with ops.plain_versions():
                    plain = servable.predict(probe)
            hammer.go.set()
            check(torch.equal(got, want) and torch.equal(got, plain),
                  f"sync: step {i}'s servable equals a fresh export and "
                  "its plain-version forward, bit for bit")
            check(prev is None or not torch.equal(got, prev),
                  f"sync: step {i}'s logits moved")
            prev = got
            del oracle, old
            shutil.rmtree(oracle_dir)
        if fault is not None:
            fault["recovered_state"] = sub.state
        hammer.stop()
        batches_run = M.Accumulator.get("serving.predict_batches").value() - b0
        requests = M.Accumulator.get("serving.predict_requests").value() - r0
        check(not hammer.failures and hammer.answered > 0,
              f"sync: zero failed predicts ({hammer.failures[:3]})")
        check(batches_run < requests, f"sync: the batcher merged requests "
              f"({batches_run} batches, {requests} requests)")
        del servable, got, want, plain, prev
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        rec["fp32"] = {
            "deltas": SYNC_DELTAS, "poll_ms": poll_ms,
            "hop_ms_median": {h: float(np.median([x[h] for x in hops]))
                              for h in ("fetch", "apply", "swap")},
            "hops": hops, "fault": fault,
            "hammer_answers": hammer.answered,
            "hammer_failures": len(hammer.failures),
            "predict_batches": batches_run, "predict_requests": requests,
            "memory_allocated_before": mem0, "memory_allocated_after": mem1}
        p.close()
        p = None

        # the device work of one apply: the table's clone and row copy
        last = list_deltas(root)[-1][1]
        ids, rows, _ = _load_delta_table(last, "categorical")
        w = srv.manager.find_model(SYNC_SIGN)._tables["categorical"][
            "weights"]
        idx = torch.from_numpy(ids.astype(np.int64)).cuda()
        src = torch.from_numpy(rows).cuda()

        def device_apply():
            nw = w.clone()
            nw.index_copy_(0, idx, src)

        rec["apply_device_ms"] = mb.device_ms(device_apply)
        # clone: the table read and written; copy: ids, rows in, rows out
        rec["apply_bound_ms"] = (2 * w.numel() * w.element_size()
                                 + ids.size * 8 + 2 * rows.nbytes
                                 ) / mb.HBM_BYTES_PER_S * 1e3
        rec["delta_rows"] = int(ids.size)
        del idx, src, w

        # the wire formats: a fresh manager follows the chain in one poll
        live = state.tables["categorical"].weights
        touched = np.unique(np.concatenate(
            [b["sparse"]["categorical"].reshape(-1) for b in batches[1:]]))
        touched = touched[touched >= 0]
        want = live[torch.from_numpy(touched).cuda()].cpu().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        delta_rows = sum(_load_delta_table(d, "categorical")[0].size
                         for _, d in list_deltas(root))
        rec["wire"] = {}
        for fmt, tol in (("fp32", 0.0), ("bf16", 3e-2), ("int8", 6e-2)):
            mgr = ModelManager(ModelRegistry(os.path.join(tmp, f"r-{fmt}")))
            mgr.load_model(SYNC_SIGN, base)
            fsub = SyncSubscriber(mgr, SYNC_SIGN, pub_url, wire=fmt)
            f0 = M.Accumulator.get("sync.bytes_fetched").value()
            t0 = time.perf_counter()
            n = fsub.poll()
            dt = time.perf_counter() - t0
            check(n == SYNC_DELTAS, f"sync: the {fmt} subscriber applied "
                  f"the chain ({fsub.status()})")
            with uncounted():
                got = mgr.find_model(SYNC_SIGN).lookup(
                    "categorical", touched).cpu().numpy()
            err = float(np.abs(got - want).max())
            check(err <= tol * scale, f"sync: {fmt} rows within {tol} x "
                  f"{scale} of the trainer's (max abs err {err})")
            cost = wire.sync_delta_cost({"categorical": (ids.size, DIM + 1)},
                                        fmt)
            gauge = M.Accumulator.get("sync.wire_bytes_per_delta",
                                      "gauge").value()
            check(gauge == cost["bytes_total"],
                  f"sync: {fmt} sync.wire_bytes_per_delta {gauge} is "
                  f"sync_delta_cost's {cost['bytes_total']}")
            fetched = M.Accumulator.get("sync.bytes_fetched").value() - f0
            rec["wire"][fmt] = {
                "ms_per_delta": dt * 1e3 / SYNC_DELTAS,
                "last_hops": fsub.status()["last_hops"]["hops"],
                "rows_per_s": delta_rows / dt,
                "bytes_fetched_per_delta": fetched / SYNC_DELTAS,
                "last_delta_cost": cost, "max_abs_err": err}
            del mgr, fsub
            torch.cuda.empty_cache()

        # REST p50 at 4096 rows: batcher on (this node), subscriber polling
        # and idle; batcher off on the restore node below
        sub.interval_s = 0.05
        sub.start()
        rec["rest_p50_ms_batcher_sub_polling"] = _rest_p50(client, probe)
        sub.stop()
        rec["rest_p50_ms_batcher_sub_idle"] = _rest_p50(client, probe)

        # restore: a third node rebuilds the servable from the live peer
        dest = os.path.join(tmp, "restored")
        t0 = time.perf_counter()
        restore_from_peer(url, SYNC_SIGN, dest, page=SYNC_PAGE)
        restore_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(dest) for f in fs)
        rnode, _, rurl = _serve(make_server, os.path.join(tmp, "reg-r"))
        servers.append(rnode)
        rclient = ServingClient(rurl, timeout=300)
        rclient.create_model(SYNC_SIGN, dest)
        restored = rnode.manager.find_model(SYNC_SIGN)
        source = srv.manager.find_model(SYNC_SIGN)
        with uncounted():
            same = torch.equal(restored.predict(probe),
                               source.predict(probe))
        check(same, "sync: the restored servable's logits equal its peer's")
        rec["restore"] = {"seconds": restore_s, "bytes": nbytes,
                          "mb_per_s": nbytes / 1e6 / restore_s,
                          "page_rows": SYNC_PAGE}
        rec["rest_p50_ms_no_batcher"] = _rest_p50(rclient, probe)
        counted = ops.launch_counts()
        launches = ran_launches({k: counted[k] - excluded[k]
                                 for k in KERNELS}, [graph_record(step)])
        rec["launches"] = launches
        rec["check_launches"] = excluded
        for k in ("gather_rows", "fused_sparse_apply"):
            check(launches[k] > 0, f"the sync path launched {k}")
        rec["wall_seconds"] = time.perf_counter() - t_phase
        emit({"phase": "sync", **rec})
        return launches
    finally:
        if hammer is not None:
            hammer.stop()
        if sub is not None:
            sub.stop()
        if p is not None:
            p.close()
        for httpd in servers:
            for s in httpd.subscribers.values():
                s.stop()
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(tmp, ignore_errors=True)

SHARD_SIGN = "deepfm-shard-0"
SHARD_SEED = TRAIN_SEED + 29  # synthetic_criteo seed of the shard phase
SHARD_T = (4, 2)          # shards of the array flagship's servables
SHARD_STAGED = 4          # gloo ranks that write the sharded layout
SHARD_DELTAS = 3          # deltas the subscriber follows
SHARD_PREDICTS = 20       # predicts of 4096 rows a p50 (after 2 untimed)


def shard_write_rank(mesh, single: str, sharded: str) -> int:
    """One of the staged ranks: the single-layout checkpoint loaded into
    this rank's shard of a `MeshTrainer` state and written again in the
    sharded layout -> the step it loaded."""
    import torch
    from openembedding_tpu_torch import data, optimizers
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    check(mesh.staged and mesh.size == SHARD_STAGED, f"a staged mesh {mesh}")
    trainer = MeshTrainer(make_deepfm(vocabulary=VOCAB, dim=DIM),
                          optimizers.Adagrad(learning_rate=0.05), mesh=mesh)
    batch = local_batch(next(data.synthetic_criteo(
        BATCH, id_space=VOCAB, seed=SHARD_SEED, steps=1)), mesh)
    state = trainer.load(trainer.init(batch), single)
    trainer.save(state, sharded, include_optimizer=False)
    return int(state.step)


def _p50_ms(torch, fn, n=SHARD_PREDICTS) -> float:
    """Median wall ms of `fn()` up to its result on the host, after two
    untimed calls."""
    fn(), fn()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        if isinstance(out, torch.Tensor):
            out.cpu()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def _shard_bytes(sm) -> list:
    return [sum(t.numel() * t.element_size() for t in ts.tensors())
            for ts in sm.tables["categorical"]]


def phase_shard(torch, mb, ops, data, optimizers, smi: str) -> dict:
    """Sharded serving at full width -> {kernel: launches of the phase}.
    See the module docstring, item 19. Launches of the checks and of the
    standalone twins are taken out of the counts."""
    import dataclasses
    import urllib.error
    from openembedding_tpu_torch.embedding import lookup as table_lookup
    from openembedding_tpu_torch.export import (StandaloneModel,
                                                export_standalone)
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.ops import gather
    from openembedding_tpu_torch.parallel.multihost import run_local
    from openembedding_tpu_torch.parallel.serving import ShardedModel
    from openembedding_tpu_torch.persist import (IncrementalPersister,
                                                 PersistPolicy)
    from openembedding_tpu_torch.serving import (ModelManager, ModelRegistry,
                                                 ServingClient, make_server,
                                                 restore_from_peer)
    from openembedding_tpu_torch.sync import SyncSubscriber

    excluded = {k: 0 for k in KERNELS}

    @contextlib.contextmanager
    def uncounted():
        """Launches of a check or of a standalone twin are taken out of
        the path's counts."""
        before = ops.launch_counts()
        yield
        after = ops.launch_counts()
        for k in excluded:
            excluded[k] += after[k] - before[k]

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-shard-")
    servers, subs, p, hammer = [], [], None, None
    rec = {"card": smi}
    try:
        batches = list(data.synthetic_criteo(BATCH, id_space=VOCAB,
                                             seed=SHARD_SEED,
                                             steps=1 + SHARD_DELTAS))
        probe = {k: batches[0][k] for k in ("sparse", "dense")}
        # one batch's ids with -1 pads and out-of-range ids
        rng = np.random.default_rng(SEED + 19)
        ids = np.array(batches[0]["sparse"]["categorical"])
        ids[rng.random(ids.shape) < 0.05] = -1
        ids[rng.random(ids.shape) < 0.02] = VOCAB + 17
        flat = torch.from_numpy(ids.reshape(-1)).cuda()
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)
        spec = model.specs["categorical"]
        trainer = Trainer(model, optimizers.Adagrad(learning_rate=0.05))
        state = trainer.init(batches[0])
        step = trainer.jit_train_step()
        root = os.path.join(tmp, "persist")
        single = os.path.join(tmp, "single")
        sharded = os.path.join(tmp, "sharded")
        export = os.path.join(tmp, "export")

        ops.reset_launch_counts()  # the path's run: counts read just after
        p = IncrementalPersister(trainer, model, root, window=2,
                                 policy=PersistPolicy(every_steps=1),
                                 full_every=100)
        state, _ = step(state, batches[0])
        p.maybe_persist(state, batch=batches[0])
        p.wait()
        t0 = time.perf_counter()
        trainer.save(state, single, include_optimizer=False)
        rec["single_save_seconds"] = time.perf_counter() - t0
        export_standalone(state, model, export, model_sign=SHARD_SIGN)
        t0 = time.perf_counter()
        loaded = run_local(shard_write_rank, SHARD_STAGED, backend="gloo",
                           device="cuda", args=(single, sharded),
                           timeout_s=600, threads=0)
        rec["sharded_write_seconds"] = time.perf_counter() - t0
        check(loaded == [1] * SHARD_STAGED, f"shard: the ranks loaded step "
              f"1 ({loaded})")
        live = state.tables["categorical"].weights
        want = gather.gather_rows_reference(live, flat).reshape(
            ids.shape + (DIM + 1,))
        standalone = StandaloneModel.load(export)
        with uncounted():
            want_logits = standalone.predict(probe)

        # (a) the array flagship, both layouts, at T = 4 and 2
        rec["array"] = []
        for layout, path in (("single", single), ("sharded", sharded)):
            for T in SHARD_T:
                t0 = time.perf_counter()
                sm = ShardedModel.load(path, devices=["cuda:0"] * T)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                shards = sm.tables["categorical"]
                check(len(shards) == T and all(
                    ts.weights.is_cuda and tuple(ts.weights.shape)
                    == (spec.rows_per_shard(T), DIM + 1) and ts.slots == {}
                    for ts in shards), f"shard: {layout} T={T}: every "
                    "shard holds rows_per_shard(T) rows, no slots")
                check(torch.equal(sm.lookup("categorical", ids), want),
                      f"shard: {layout} T={T}: lookups bit-equal to the "
                      "trainer's rows by id")
                before = ops.launch_counts()["gather_rows"]
                logits = sm.predict(probe)
                torch.cuda.synchronize()
                per_predict = ops.launch_counts()["gather_rows"] - before
                check(per_predict == T, f"shard: {layout} T={T}: one "
                      f"gather a shard a predict ({per_predict})")
                with uncounted():
                    with ops.plain_versions():
                        plain = sm.predict(probe)
                check(torch.equal(logits, want_logits)
                      and torch.equal(logits, plain),
                      f"shard: {layout} T={T}: predict at {BATCH} rows "
                      "bit-equal to StandaloneModel's and to its plain "
                      "gather's")
                r = {"layout": layout, "T": T, "load_seconds": load_s,
                     "shard_bytes": _shard_bytes(sm),
                     "gather_launches_per_predict": per_predict,
                     "predict_p50_ms": _p50_ms(
                         torch, lambda: sm.predict(probe))}
                with uncounted():  # the standalone servable, in turn
                    r["standalone_predict_p50_ms"] = _p50_ms(
                        torch, lambda: standalone.predict(probe))
                if layout == "single" and T == SHARD_T[0]:
                    r["profile"] = profile_device(
                        torch, lambda: sm.predict(probe).cpu())
                rec["array"].append(r)
                del sm, logits, plain
        torch.cuda.empty_cache()

        # (b) the hashed flagship at T = 4
        hmodel = make_deepfm(VOCAB, DIM, hashed=True, capacity=HASH_CAPACITY)
        htrainer = Trainer(hmodel, optimizers.Adagrad(learning_rate=0.05))
        hbatch = next(data.synthetic_criteo(BATCH, id_space=HASH_ID_SPACE,
                                            seed=SHARD_SEED, steps=1))
        hstate = htrainer.init(hbatch)
        hstep = htrainer.jit_train_step()
        hstate, _ = hstep(hstate, hbatch)
        hsingle = os.path.join(tmp, "hash_single")
        htrainer.save(hstate, hsingle, include_optimizer=False)
        hids = np.array(hbatch["sparse"]["categorical"])
        hids[rng.random(hids.shape) < 0.05] = -1
        absent = rng.integers(0, HASH_ID_SPACE, size=hids.shape)
        fresh = rng.random(hids.shape) < 0.05
        hids[fresh] = absent[fresh]
        hflat = torch.from_numpy(hids.reshape(-1)).cuda()
        with uncounted():
            hwant = table_lookup(hmodel.specs["categorical"],
                                 hstate.tables["categorical"], hflat)
        resident = int((hstate.tables["categorical"].keys >= 0).sum())
        t0 = time.perf_counter()
        hsm = ShardedModel.load(hsingle, devices=["cuda:0"] * 4)
        torch.cuda.synchronize()
        hload = time.perf_counter() - t0
        got = hsm.lookup("categorical", hids).reshape(-1, DIM + 1)
        check(torch.equal(got, hwant), "shard: the hashed flagship's "
              "lookups at T=4 bit-equal to the trainer's read-only pull")
        keys = torch.cat([ts.keys for ts in hsm.tables["categorical"]])
        gone = ~np.isin(hids.reshape(-1), keys.cpu().numpy())
        check(bool(gone.any()) and not bool(
            got[torch.from_numpy(gone).cuda()].any()),
            "shard: absent ids pull zero rows")
        before = ops.launch_counts()["gather_rows"]
        hsm.predict({"sparse": hbatch["sparse"], "dense": hbatch["dense"]})
        torch.cuda.synchronize()
        rec["hash"] = {
            "T": 4, "resident_ids": resident, "load_seconds": hload,
            "jax_slots_per_shard": max(-(-resident * 10 // 28), 64),
            "slots_per_shard": [int(ts.keys.shape[0])
                                for ts in hsm.tables["categorical"]],
            "shard_bytes": _shard_bytes(hsm),
            "gather_launches_per_predict":
                ops.launch_counts()["gather_rows"] - before,
            "predict_p50_ms": _p50_ms(torch, lambda: hsm.predict(
                {"sparse": hbatch["sparse"], "dense": hbatch["dense"]}))}
        del hsm, hstate, htrainer, got, hwant, keys
        torch.cuda.empty_cache()

        # (c) REST: shard_num=4 staged on the one card
        srv, _, url = _serve(make_server, os.path.join(tmp, "reg"),
                             devices=["cuda:0"] * 4)
        servers.append(srv)
        client = ServingClient(url, timeout=300)
        t0 = time.perf_counter()
        entry = client.create_model(SHARD_SIGN, single, shard_num=4)
        rec["rest_load_seconds"] = time.perf_counter() - t0
        sm = srv.manager.find_model(SHARD_SIGN)
        check(entry["status"] == "NORMAL" and isinstance(sm, ShardedModel)
              and sm.num_shards == 4, f"shard: POST /models shard_num=4 "
              f"ends NORMAL ({entry})")
        pulled = client.pull(SHARD_SIGN, "categorical", ids[:64],
                             binary=True)
        check(np.array_equal(pulled, want[:64].cpu().numpy()),
              "shard: the REST pull answers the trainer's rows")
        rest = client.predict(SHARD_SIGN, probe["sparse"], probe["dense"])
        check(np.array_equal(rest, want_logits.cpu().numpy()),
              "shard: the REST predict answers the standalone logits")
        try:
            client.create_model("deepfm-toobig-0", single, shard_num=8)
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
        check(refused == 500 and srv.manager.registry.get(
            "deepfm-toobig-0")["status"] == "ERROR",
            f"shard: shard_num=8 on a list of 4 is refused ({refused})")
        client.create_model(SHARD_SIGN + "-standalone", export)
        rec["rest_predict_p50_ms"] = _rest_p50(
            client, probe, sign=SHARD_SIGN)
        with uncounted():
            rec["rest_standalone_predict_p50_ms"] = _rest_p50(
                client, probe, sign=SHARD_SIGN + "-standalone")
        dest = os.path.join(tmp, "restored")
        t0 = time.perf_counter()
        restore_from_peer(url, SHARD_SIGN, dest, page=SYNC_PAGE)
        restore_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(dest) for f in fs)
        with uncounted():
            restored = StandaloneModel.load(dest)
            same = torch.equal(restored.predict(probe), want_logits)
        check(same, "shard: the export restored from the sharded peer "
              "gives bit-equal logits")
        rec["restore"] = {"seconds": restore_s, "bytes": nbytes,
                          "mb_per_s": nbytes / 1e6 / restore_s,
                          "page_rows": SYNC_PAGE}
        del restored, sm, want
        shutil.rmtree(dest)

        # (d) sync: a subscriber follows the deltas into the sharded
        # servable; a standalone twin follows the same feed
        pub, _, pub_url = _serve(make_server, os.path.join(tmp, "reg-pub"),
                                 publish={SHARD_SIGN: root})
        servers.append(pub)
        sub = SyncSubscriber(srv.manager, SHARD_SIGN, pub_url)
        subs.append(sub)
        check(sub.poll() == 0 and sub.version == 1,
              f"shard: the subscriber negotiated the base ({sub.status()})")
        twin = ModelManager(ModelRegistry(os.path.join(tmp, "reg-twin")))
        twin.load_model(SHARD_SIGN, export)
        tsub = SyncSubscriber(twin, SHARD_SIGN, pub_url)
        subs.append(tsub)
        with uncounted():
            check(tsub.poll() == 0, "shard: the twin negotiated the base")
        touched = np.unique(np.concatenate(
            [b["sparse"]["categorical"].reshape(-1) for b in batches]))
        touched = touched[touched >= 0]
        tflat = torch.from_numpy(touched).cuda()
        hammer = _Hammer(url, probe, SYNC_HAMMERS, SYNC_HAMMER_ROWS,
                         sign=SHARD_SIGN)
        hops, twin_hops = [], []
        for i, b in enumerate(batches[1:], start=2):
            state, _ = step(state, b)
            p.maybe_persist(state, batch=b)
            p.wait()
            old = srv.manager.find_model(SHARD_SIGN)
            hammer.pause()
            with uncounted():
                old_rows = old.lookup("categorical", touched)
            hammer.go.set()
            check(sub.poll() == 1 and sub.version == i,
                  f"shard: delta {i} applied ({sub.status()})")
            hops.append(sub.status()["last_hops"]["hops"])
            with uncounted():
                check(tsub.poll() == 1, f"shard: the twin applied {i}")
            twin_hops.append(tsub.status()["last_hops"]["hops"])
            new = srv.manager.find_model(SHARD_SIGN)
            check(new is not old and new.step == i,
                  f"shard: the servable swapped to step {i}")
            hammer.pause()
            with uncounted():
                got = new.lookup("categorical", touched)
                same_old = torch.equal(old.lookup("categorical", touched),
                                       old_rows)
            hammer.go.set()
            check(torch.equal(got, live[tflat]), f"shard: step {i}'s rows "
                  "bit-equal to the trainer's by id")
            check(same_old, f"shard: the servable before step {i} is "
                  "unchanged")
            del old, new, got, old_rows
        hammer.stop()
        check(not hammer.failures and hammer.answered > 0,
              f"shard: zero failed predicts across the swaps "
              f"({hammer.failures[:3]})")
        rec["sync"] = {
            "deltas": SHARD_DELTAS, "hammer_answers": hammer.answered,
            "apply_ms": [h["apply"] for h in hops],
            "twin_apply_ms": [h["apply"] for h in twin_hops],
            "apply_ms_median": float(np.median([h["apply"] for h in hops])),
            "twin_apply_ms_median": float(np.median(
                [h["apply"] for h in twin_hops])),
            "hops": hops}
        for s_ in subs:
            s_.stop()
        p.close()
        p = None
        del twin, tsub, sub
        torch.cuda.empty_cache()

        # (e) bfloat16: a DeepFM whose table is bfloat16, standalone and
        # sharded
        bmodel = make_deepfm(vocabulary=VOCAB, dim=DIM)
        bmodel.specs["categorical"] = dataclasses.replace(
            spec, datatype="bfloat16")
        btrainer = Trainer(bmodel, optimizers.Adagrad(learning_rate=0.05))
        bstate = btrainer.init(batches[0])
        bstate, _ = btrainer.train_step(bstate, batches[0])
        bw = bstate.tables["categorical"].weights
        check(bw.dtype == torch.bfloat16, "shard: a bfloat16 table")
        bexport = os.path.join(tmp, "bf16_export")
        bsingle = os.path.join(tmp, "bf16_single")
        export_standalone(bstate, bmodel, bexport)
        btrainer.save(bstate, bsingle, include_optimizer=False)
        bwant = gather.gather_rows_reference(bw, flat).reshape(
            ids.shape + (DIM + 1,))
        with uncounted():
            bso = StandaloneModel.load(bexport, model=bmodel)
            bso_rows = bso.lookup("categorical", ids)
            bso_logits = bso.predict(probe)
        bsm = ShardedModel.load(bsingle, devices=["cuda:0"] * 4,
                                model=bmodel)
        bsm_rows = bsm.lookup("categorical", ids)
        check(bso_rows.dtype == bsm_rows.dtype == torch.bfloat16
              and torch.equal(bso_rows, bwant)
              and torch.equal(bsm_rows, bwant),
              "shard: bfloat16 rows, standalone and sharded, bit-equal to "
              "the trainer's")
        check(torch.equal(bsm.predict(probe), bso_logits),
              "shard: the bfloat16 servables' logits are equal")
        rec["bf16"] = {"shard_bytes": _shard_bytes(bsm),
                       "export_bytes": os.path.getsize(os.path.join(
                           bexport, "variable_0", "weights.npy"))}
        del bsm, bso, bstate, btrainer, bw, bwant

        counted = ops.launch_counts()
        launches = ran_launches({k: counted[k] - excluded[k]
                                 for k in KERNELS},
                                [graph_record(step), graph_record(hstep)])
        rec["launches"] = launches
        rec["check_launches"] = excluded
        for k in ("gather_rows", "fused_sparse_apply"):
            check(launches[k] > 0, f"the shard path launched {k}")
        rec["wall_seconds"] = time.perf_counter() - t_phase
        emit({"phase": "shard", **rec})
        return launches
    finally:
        if hammer is not None:
            hammer.stop()
        for s_ in subs:
            s_.stop()
        if p is not None:
            p.close()
        for httpd in servers:
            for s_ in httpd.subscribers.values():
                s_.stop()
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(tmp, ignore_errors=True)


INGEST_K = 8              # steps a window (bench.py case_ingest's K)
INGEST_SEED = TRAIN_SEED + 41  # synthetic_criteo seed of the first file
# windows of each stream; two synthetic "days" each, K * windows / 2 steps
INGEST_WINDOWS = {"ceiling": 6, "replay": 24, "synthetic": 16,
                  "throttled": 4}
INGEST_STAGED_K = 4       # the staged ranks' windows: 2 of 4 steps
INGEST_STAGED_WINDOWS = 2
INGEST_TSV_BATCHES = 4    # the TSV read back off a URI, batches of 4096
INGEST_SCHEME = "oefs"    # the phase's own filesystem scheme


def _ingest_files(seed: int, windows: int, k: int = INGEST_K) -> list:
    """Two synthetic spec "files" holding `windows` windows of `k` steps."""
    return [f"synthetic://steps={windows * k // 2}&seed={seed + s}"
            f"&id_space={VOCAB}" for s in range(2)]


def _oefs(fsmod, root: str):
    """A ShellPipeFS over cat / cp / test / ls / mkdir that keeps
    `oefs://<path>` under `<path>` (the shell strips the scheme)."""
    strip = 'p="${{0#' + INGEST_SCHEME + '://}}"; '

    def sh(cmd):
        return ["sh", "-c", strip + cmd, "{path}"]

    return fsmod.ShellPipeFS(
        cat=sh('cat "$p"'),
        put=sh('mkdir -p "$(dirname "$p")" && cat > "$p"'),
        test=sh('test -e "$p"'), ls=sh('ls "$p"'), mkdir=sh('mkdir -p "$p"'),
        testdir=sh('test -d "$p"'),
        puttree=["sh", "-c", 'mkdir -p "${{1#' + INGEST_SCHEME
                 + '://}}" && cp -r "$0"/. "${{1#' + INGEST_SCHEME
                 + '://}}"', "{local}", "{path}"])


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def ingest_staged_rank(mesh, files):
    """One of the staged ranks (gloo, tensors on the card): the flagship
    fed by `ingest.feed(files, BATCH, mesh=mesh, window=4)` into
    `train_stream`, each window's collective fingerprint taken as it runs;
    then the same global windows built by hand (each batch's rows of this
    rank, stacked) through `train_many` from a clone of the initial state:
    losses and state bit-equal. Returns numbers only."""
    import torch
    from openembedding_tpu_torch import ops, optimizers
    from openembedding_tpu_torch import microbench as mb
    from openembedding_tpu_torch.data import ingest
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer
    from openembedding_tpu_torch.parallel.multihost import local_batch
    from openembedding_tpu_torch.utils import guards, metrics
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(mesh.staged and mesh.size == MESH_STAGED, f"a staged mesh {mesh}")
    metrics.reset_all()
    model = make_deepfm(vocabulary=VOCAB, dim=DIM)
    trainer = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                          mesh=mesh, wire="fp32")
    globals_ = [b for f in files
                for b in ingest.SOURCES["synthetic"](f, BATCH)]
    state = trainer.init(local_batch(globals_[0], mesh))
    ref = state.clone()
    fps, losses = [], []

    def driver(st, w):
        box = {}

        def window():
            box["out"] = trainer.train_many(st, w)

        fps.append(guards.collective_fingerprint(window))
        st, m = box["out"]
        losses.append(m["loss"].clone())
        return st, m

    ops.reset_launch_counts()  # the path's run: counts read just after
    staged0 = mesh.staged_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring = ingest.feed(files, BATCH, mesh=mesh, source="synthetic",
                       window=INGEST_STAGED_K, workers=2, depth=2,
                       label="staged")
    state, rep = trainer.train_stream(state, ring, driver=driver)
    torch.cuda.synchronize()
    share = ingest.input_wait_share()
    steps = INGEST_STAGED_K * INGEST_STAGED_WINDOWS
    ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = _mesh_launches(ops.launch_counts())
    staged = (mesh.staged_bytes - staged0) / steps
    ref_losses = []
    for w in range(INGEST_STAGED_WINDOWS):
        host = [local_batch(b, mesh) for b in
                globals_[w * INGEST_STAGED_K:(w + 1) * INGEST_STAGED_K]]
        ref, m = trainer.train_many(ref, _stacked(host))
        ref_losses.append(m["loss"].clone())
    cmp = _compare(torch, mb, state, torch.cat(losses).cpu().numpy(), ref,
                   torch.cat(ref_losses).cpu().numpy(), "vs_hand_windows")
    return {"rank": mesh.rank, "windows": rep["windows"], "fps": fps,
            "losses": torch.cat(losses).cpu().numpy().tolist(),
            "launches": launches, "ms_per_step": ms,
            "input_wait_share": share,
            "staged_bytes_per_step": staged, **cmp}


def _ingest_stream(torch, tr, state, ring, driver, losses, ingest,
                   metrics) -> tuple:
    """`train_stream` over `ring` (the registry reset just before) ->
    (state, the stream's record)."""
    label = ring._labels["ring"]
    losses.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rep = tr.train_stream(state, ring, driver=driver)
    seconds = time.perf_counter() - t0
    share = ingest.input_wait_share()
    report = metrics.report()
    windows = rep["windows"]
    return state, {
        "windows": windows, "seconds": seconds,
        "ex_per_s": windows * INGEST_K * BATCH / seconds,
        "input_wait_share": share, "loss": rep["loss"],
        "window_ms_mean": report.get("trainer.window_ms"),
        "window_ms_p50": report.get("trainer.window_ms.p50"),
        "input_wait_ms_mean": report.get("trainer.input_wait_ms"),
        "input_wait_ms_p50": report.get("trainer.input_wait_ms.p50"),
        "input_wait_ms_p99": report.get("trainer.input_wait_ms.p99"),
        "stage_ms_mean": report.get(f'ingest.stage_ms{{ring="{label}"}}'),
        "stage_ms_p99": report.get(
            f'ingest.stage_ms{{ring="{label}"}}.p99'),
        "parse_ms_mean": report.get(f'ingest.parse_ms{{pool="{label}"}}')}


def phase_ingest(torch, mb, ops, data, optimizers, smi: str) -> dict:
    """The ingest path and remote storage at full width -> {kernel:
    launches of the phase}. See the module docstring, item 20."""
    import torch.distributed as dist
    from openembedding_tpu_torch.data import ingest
    from openembedding_tpu_torch.export import (StandaloneModel,
                                                export_standalone)
    from openembedding_tpu_torch.models import make_deepfm
    from openembedding_tpu_torch.parallel import MeshTrainer, make_mesh
    from openembedding_tpu_torch.parallel import multihost
    from openembedding_tpu_torch.parallel.multihost import run_local
    from openembedding_tpu_torch.utils import fs as fsmod
    from openembedding_tpu_torch.utils import guards, metrics

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-ingest-")
    rec = {"card": smi, "batch": BATCH, "window": INGEST_K}
    multihost.initialize("nccl", init_file=os.path.join(tmp, "store"),
                         rank=0, world_size=1)
    try:
        mesh = make_mesh()
        check(mesh.size == 1 and mesh.device.type == "cuda",
              f"ingest: a one-rank mesh on the card ({mesh})")
        model = make_deepfm(vocabulary=VOCAB, dim=DIM)
        tr = MeshTrainer(model, optimizers.Adagrad(learning_rate=0.05),
                         mesh=mesh, capacity_factor=0.0, wire="fp32",
                         pipeline_steps=True)
        many = tr._many_driver()  # what train_stream drives by default
        guarded = guards.assert_no_recompile(many, label="ingest.many")
        losses = []

        def driver(st, w):
            st, m = guarded(st, w)
            losses.append(m["loss"].clone())  # the next replay overwrites
            return st, m

        # (1) the ceiling: pre-staged windows through the graph driver
        files = _ingest_files(INGEST_SEED, INGEST_WINDOWS["ceiling"])
        first = next(ingest.SOURCES["synthetic"](files[0], BATCH))
        staged = list(ingest.feed(files, BATCH, mesh=mesh,
                                  source="synthetic", window=INGEST_K,
                                  depth=2, label="stage"))
        check(len(staged) == INGEST_WINDOWS["ceiling"],
              "ingest: the ceiling's windows")
        state = tr.init(first)
        times = []
        for i, w in enumerate(staged):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = driver(state, w)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3 / INGEST_K)
        del staged
        ceiling_ms = min(times)
        check(many.captures == 1 and [
                row_launches(g) for g in many.graph_launches] == [
            {"gather_rows": INGEST_K, "gather_rows_windows": 0,
             "fused_sparse_apply": INGEST_K}],
            f"ingest: one capture, K gathers and K applies a window "
            f"({graph_record(many)})")
        rec["ceiling"] = {"ms_per_step_min": ceiling_ms,
                          "ms_per_step_median": float(np.median(times)),
                          "ex_per_s": BATCH / ceiling_ms * 1e3}

        # (2) replay line rate: batches parsed before the timer, served by
        # a registered source; the ring only stacks and stages them
        rfiles = _ingest_files(INGEST_SEED + 2, INGEST_WINDOWS["replay"])
        parsed = {f: list(ingest.SOURCES["synthetic"](f, BATCH))
                  for f in rfiles}
        ingest.register_source(
            "smoke_replay", lambda path, batch_size, **kw: iter(parsed[path]))
        start = state.clone()
        ops.reset_launch_counts()  # the path's run: counts read just after
        before = graph_record(many)
        metrics.reset_all()
        state, rec["replay"] = _ingest_stream(
            torch, tr, state, ingest.feed(
                rfiles, BATCH, mesh=mesh, source="smoke_replay",
                window=INGEST_K, depth=3, label="replay"),
            driver, losses, ingest, metrics)
        replay_losses = torch.cat(losses).cpu().numpy()
        after_replay = state.clone()

        # (3) synthetic line rate: parsed by two workers as it streams
        metrics.reset_all()
        state, rec["synthetic"] = _ingest_stream(
            torch, tr, state, ingest.feed(
                _ingest_files(INGEST_SEED + 4, INGEST_WINDOWS["synthetic"]),
                BATCH, mesh=mesh, source="synthetic", workers=2, depth=3,
                window=INGEST_K, label="synthetic"),
            driver, losses, ingest, metrics)

        # (4) throttled: the producer paced at 2x the ceiling a batch,
        # depth 1, as the soak's control (synthetic, two workers); and the
        # same pace over the replay source
        throttle_s = 2 * ceiling_ms / 1e3
        metrics.reset_all()
        state, rec["throttled"] = _ingest_stream(
            torch, tr, state, ingest.feed(
                _ingest_files(INGEST_SEED + 6, INGEST_WINDOWS["throttled"]),
                BATCH, mesh=mesh, source="synthetic", workers=2, depth=1,
                window=INGEST_K, label="slow", throttle_s=throttle_s),
            driver, losses, ingest, metrics)
        metrics.reset_all()
        state, rec["throttled_replay"] = _ingest_stream(
            torch, tr, state, ingest.feed(
                rfiles, BATCH, mesh=mesh, source="smoke_replay", depth=1,
                window=INGEST_K, label="slow_replay", throttle_s=throttle_s),
            driver, losses, ingest, metrics)
        rec["throttle_s"] = throttle_s
        counted = ops.launch_counts()
        after = graph_record(many)
        launches = {k: counted[k]
                    + after["launches_replayed"].get(k, 0)
                    - before["launches_replayed"].get(k, 0)
                    - after["launches_captured"].get(k, 0)
                    + before["launches_captured"].get(k, 0)
                    for k in KERNELS}
        windows_run = sum(rec[k]["windows"] for k in (
            "replay", "synthetic", "throttled", "throttled_replay"))
        check(launches == {"gather_rows": INGEST_K * windows_run,
                           "gather_rows_windows": 0,
                           "fused_sparse_apply": INGEST_K * windows_run},
              f"ingest: K gathers and K applies ran a window ({launches})")
        check(many.captures == 1 and guarded.trace_count() == 1,
              f"ingest: one capture across every stream "
              f"({graph_record(many)})")
        for k, want in (("replay", INGEST_WINDOWS["replay"]),
                        ("synthetic", INGEST_WINDOWS["synthetic"]),
                        ("throttled", INGEST_WINDOWS["throttled"]),
                        ("throttled_replay", INGEST_WINDOWS["replay"])):
            check(rec[k]["windows"] == want,
                  f"ingest: {k} ran {want} windows ({rec[k]['windows']})")
        check(rec["throttled"]["input_wait_share"] > 0.5,
              f"ingest: the throttled stream reads input-bound "
              f"({rec['throttled']['input_wait_share']})")

        # (5) the replay stream against the same windows through the plain
        # versions, eager, from the same initial state
        host_windows = list(ingest.FeedRing(
            ingest.sharded_reader(rfiles, BATCH, source="smoke_replay"),
            window=INGEST_K, device=False, label="replay_host"))
        ref, ref_losses = start, []
        with ops.plain_versions():
            for w in host_windows:
                ref, m = tr.train_many(ref, w)
                ref_losses.append(m["loss"])
        plain = ops.launch_counts()
        check(all(plain[k] == counted[k] for k in KERNELS),
              "ingest: the plain run launched no kernel")
        rec["bit_equality"] = _compare(
            torch, mb, after_replay, replay_losses, ref,
            torch.cat(ref_losses).cpu().numpy(), "replay_vs_plain")
        del ref, start, after_replay, host_windows
        torch.cuda.empty_cache()

        # (6) four staged gloo ranks on the card, fed by the ring
        sfiles = _ingest_files(INGEST_SEED + 8, INGEST_STAGED_WINDOWS,
                               INGEST_STAGED_K)
        t0 = time.perf_counter()
        ranks = run_local(ingest_staged_rank, MESH_STAGED, backend="gloo",
                          device="cuda", args=(sfiles,), timeout_s=600,
                          threads=0)
        fp0 = ranks[0]["fps"][0]
        for out in ranks:
            check(out["windows"] == INGEST_STAGED_WINDOWS,
                  f"ingest: rank {out['rank']} ran its windows")
            check(out["fps"] == [fp0] * INGEST_STAGED_WINDOWS,
                  f"ingest: rank {out['rank']}'s fingerprints equal every "
                  f"rank's across both windows ({out['fps']}, {fp0})")
            for k in ("gather_rows", "fused_sparse_apply"):
                check(out["launches"][k] > 0,
                      f"ingest: staged rank {out['rank']} launched {k}")
                launches[k] += out["launches"][k]
        rec["staged"] = {"ranks": MESH_STAGED,
                         "wall_seconds": time.perf_counter() - t0,
                         "fingerprint": fp0, "per_rank": ranks}

        # (7) remote storage through the phase's own scheme
        root = os.path.join(tmp, "remote")
        fsmod.register_filesystem(INGEST_SCHEME, _oefs(fsmod, root))
        uri = f"{INGEST_SCHEME}://{root}"
        remote = {}
        t0 = time.perf_counter()
        tr.save(state, f"{uri}/ckpt")
        remote["save_seconds"] = time.perf_counter() - t0
        remote["checkpoint_bytes"] = _dir_bytes(os.path.join(root, "ckpt"))
        fresh = tr.init(first)
        t0 = time.perf_counter()
        fresh = tr.load(fresh, f"{uri}/ckpt")
        remote["load_seconds"] = time.perf_counter() - t0
        unequal = _bits_equal(torch, mb, mb.state_bits(fresh),
                              mb.state_bits(state))
        check(not unequal, f"ingest: the checkpoint loaded from the URI is "
              f"bit-equal ({unequal})")
        del fresh
        torch.cuda.empty_cache()
        exp = os.path.join(tmp, "export")
        export_standalone(state, model, exp)
        nbytes = _dir_bytes(exp)
        t0 = time.perf_counter()
        fsmod.stage_out(exp, f"{uri}/export")
        out_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = fsmod.stage_in(f"{uri}/export")
        in_s = time.perf_counter() - t0
        check(_dir_bytes(back) == nbytes, "ingest: stage_in brought every "
              "byte back")
        shutil.rmtree(back, ignore_errors=True)
        probe = {k: first[k] for k in ("sparse", "dense")}
        local_logits = StandaloneModel.load(exp, model=model).predict(probe)
        remote_logits = StandaloneModel.load(f"{uri}/export",
                                             model=model).predict(probe)
        check(local_logits.shape[0] == BATCH
              and torch.equal(mb.bits(local_logits), mb.bits(remote_logits)),
              "ingest: the export loaded from the URI predicts bit-equal")
        tsv = os.path.join(tmp, "day.tsv")
        write_criteo_tsv(tsv, INGEST_TSV_BATCHES * BATCH, SEED + 41)
        with fsmod.open_stream(f"{uri}/data/day.tsv", "wb") as f, \
                open(tsv, "rb") as src:
            shutil.copyfileobj(src, f)
        local_rows = list(data.read_criteo_tsv(tsv, BATCH, id_space=VOCAB,
                                               native="off"))
        t0 = time.perf_counter()
        remote_rows = list(data.read_criteo_tsv(f"{uri}/data/day.tsv", BATCH,
                                                id_space=VOCAB))
        remote["tsv_read_seconds"] = time.perf_counter() - t0
        check(len(local_rows) == INGEST_TSV_BATCHES
              and _same_batches(local_rows, remote_rows),
              "ingest: read_criteo_tsv over the URI equals the local read")
        remote.update({
            "export_bytes": nbytes, "stage_out_seconds": out_s,
            "stage_in_seconds": in_s,
            "stage_out_mb_per_s": nbytes / out_s / 1e6,
            "stage_in_mb_per_s": nbytes / in_s / 1e6,
            "checkpoint_save_mb_per_s":
                remote["checkpoint_bytes"] / remote["save_seconds"] / 1e6,
            "checkpoint_load_mb_per_s":
                remote["checkpoint_bytes"] / remote["load_seconds"] / 1e6})
        rec["remote"] = remote
        rec["launches"] = launches
        rec["graph"] = graph_record(many)
        rec["wall_seconds"] = time.perf_counter() - t_phase
        emit({"phase": "ingest", **rec})
        return launches
    finally:
        fsmod._REGISTRY.pop(INGEST_SCHEME, None)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


SOAK_STEPS = 13           # the base at step 1, then a delta every 2 steps
SOAK_PACED_STEPS = 7      # the paced run: three deltas
SOAK_EVERY = 2
SOAK_HAMMERS = 4          # predict threads across the swaps
SOAK_INTERVAL_S = 0.05    # the subscriber's poll
SOAK_HIDDEN = (400, 400, 400)
KERAS_FIELDS = 39         # the plain-Keras DeepFM's id input
KERAS_STEPS = 8


@contextlib.contextmanager
def _spied_drivers(Trainer):
    """Every `jit_train_step` driver made inside, for `ran_launches`."""
    drivers = []
    made = Trainer.jit_train_step

    def spy(self):
        d = made(self)
        drivers.append(d)
        return d

    with mock.patch.object(Trainer, "jit_train_step", spy):
        yield drivers


@contextlib.contextmanager
def _timed_subscriber(SyncSubscriber):
    """Per applied delta, the subscriber thread's wall and CPU ms in its
    fetch and in its apply and swap: {step: {...}}."""
    rec = {}
    fetch, record = SyncSubscriber._fetch_delta, SyncSubscriber._record_lineage

    def timed_fetch(self, step):
        w0, c0 = time.perf_counter(), time.thread_time()
        out = fetch(self, step)
        w1, c1 = time.perf_counter(), time.thread_time()
        rec[int(step)] = {"fetch_wall_ms": (w1 - w0) * 1e3,
                          "fetch_cpu_ms": (c1 - c0) * 1e3, "_t": (w1, c1)}
        return out

    def timed_record(self, step, *args):
        w1, c1 = rec[int(step)].pop("_t")
        rec[int(step)].update(
            apply_wall_ms=(time.perf_counter() - w1) * 1e3,
            apply_cpu_ms=(time.thread_time() - c1) * 1e3)
        return record(self, step, *args)

    with mock.patch.object(SyncSubscriber, "_fetch_delta", timed_fetch), \
            mock.patch.object(SyncSubscriber, "_record_lineage",
                              timed_record):
        yield rec


@contextlib.contextmanager
def _lock_waits():
    """A thread that sleeps 1 ms at a time; how late each sleep returns is
    mostly the time it waited for the interpreter lock. Yields a dict that
    holds, after the block, the wake-ups' lateness and the process's CPU
    seconds over the block's wall seconds."""
    late, out, stop = [], {}, threading.Event()

    def loop():
        while not stop.is_set():
            t = time.perf_counter()
            time.sleep(0.001)
            late.append(time.perf_counter() - t - 0.001)

    t = threading.Thread(target=loop, daemon=True)
    w0, c0 = time.perf_counter(), time.process_time()
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()
        ms = np.asarray(late) * 1e3
        out.update(
            wakeups=int(ms.size),
            late_ms_p50=float(np.percentile(ms, 50)),
            late_ms_p99=float(np.percentile(ms, 99)),
            late_ms_mean=float(ms.mean()),
            process_cpus=(time.process_time() - c0)
            / (time.perf_counter() - w0))


def phase_soak(ops, smi: str) -> dict:
    """The sync soak at full width -> {kernel: launches of the phase}. See
    the module docstring, item 21."""
    from openembedding_tpu_torch import sync_soak
    from openembedding_tpu_torch.model import Trainer
    from openembedding_tpu_torch.sync import SyncSubscriber, lineage
    from openembedding_tpu_torch.utils import metrics as M
    from openembedding_tpu_torch.utils import slo

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-soak-")
    rec = {"card": smi, "steps": SOAK_STEPS, "persist_every": SOAK_EVERY,
           "batch": BATCH, "hidden": list(SOAK_HIDDEN)}
    launches = {k: 0 for k in KERNELS}
    try:
        for run in ("plain", "quiet", "paced", "stall"):
            extra = {"steps": SOAK_STEPS, "predict_threads": SOAK_HAMMERS}
            if run == "quiet":
                extra["predict_threads"] = 0
            elif run == "paced":
                # a step every 1.5x the plain run's slowest delta service
                # (fetch, apply and swap), so a delta every 3x it
                pace_s = 1.5 * rec["plain"]["service_ms_max"] / 1e3
                extra.update(steps=SOAK_PACED_STEPS, step_delay_s=pace_s,
                             lag_bound_steps=2 * SOAK_EVERY)
            elif run == "stall":
                # the stall scaled to the plain run's measured delta
                # latency (birth to swap, polls included): the freshness
                # threshold 3x the slowest delta's, the stall twice that
                thr_ms = max(1000.0, 3 * rec["plain"]["delta_ms_max"])
                extra.update(stall_s=2 * thr_ms / 1e3,
                             freshness_threshold_ms=thr_ms,
                             stall_after_frac=0.25, timeline=True)
            want_swaps = (extra["steps"] - 1) // SOAK_EVERY
            M.reset_all()
            lineage.BOOK.clear()
            ops.reset_launch_counts()
            with _spied_drivers(Trainer) as drivers, \
                    _timed_subscriber(SyncSubscriber) as served, \
                    _lock_waits() as waits:
                try:
                    r = sync_soak.run(
                        persist_every=SOAK_EVERY, interval_s=SOAK_INTERVAL_S,
                        workdir=os.path.join(tmp, run), wire="fp32",
                        vocab=VOCAB, batch=BATCH, dim=DIM,
                        hidden=SOAK_HIDDEN, quiet=True, **extra)
                finally:
                    slo.configure(list(slo.DEFAULT_SLOS))
            ran = ran_launches(ops.launch_counts(),
                               [graph_record(d) for d in drivers])
            for k in KERNELS:
                launches[k] += ran[k]
            check(r["failed_predicts"] == 0 and r["final_lag_steps"] == 0,
                  f"soak ({run}): no failed predict, lag 0 at the end ({r})")
            check(r["swaps"] >= want_swaps,
                  f"soak ({run}): {r['swaps']} swaps, every delta's "
                  f"({want_swaps})")
            check(r["captures"] == 1 and len(drivers) == 1,
                  f"soak ({run}): one capture ({r['captures']})")
            check(r["servable_matches_export"] is True,
                  f"soak ({run}): the swapped servable predicts what a "
                  "fresh export of the same step does, bit for bit")
            check(ran["gather_rows"] > 0 and ran["fused_sparse_apply"] > 0,
                  f"soak ({run}): the gather and the apply ran ({ran})")
            out = {k: r[k] for k in (
                "swaps", "predicts", "failed_predicts", "final_version",
                "max_observed_lag_steps", "wall_s", "slo",
                "collective_fingerprint", "captures")}
            out.update(launches=ran, predict_threads=extra["predict_threads"],
                       step_delay_s=extra.get("step_delay_s", 0.0),
                       lock_waits=waits)
            # each delta: birth to swap, the gap since the last delta's
            # commit (the trainer's cadence), the subscriber thread's wall
            # and CPU ms in its fetch and in its apply and swap
            deltas, commit = [], None
            for d in lineage.BOOK.export("soak-0"):
                if not (d.get("birth") and d.get("swapped")):
                    continue
                deltas.append({
                    "step": d["step"],
                    "birth_to_swap_ms": (d["swapped"] - d["birth"]) * 1e3,
                    "commit_gap_ms": None if commit is None
                    else (d["commit"] - commit) * 1e3,
                    **served.get(d["step"], {})})
                commit = d["commit"]
            out["deltas"] = deltas
            out["delta_ms"] = [d["birth_to_swap_ms"] for d in deltas]
            check(len(deltas) >= want_swaps
                  and all("apply_wall_ms" in d for d in deltas),
                  f"soak ({run}): every delta's lineage ({deltas})")
            out["delta_ms_max"] = max(out["delta_ms"])
            out["service_ms_max"] = max(
                d["fetch_wall_ms"] + d["apply_wall_ms"] for d in deltas)
            if run == "paced":
                # lag_bound_steps held inside the run; the latency must not
                # build up from delta to delta
                grew = max(out["delta_ms"]) - out["delta_ms"][0]
                check(grew <= out["service_ms_max"],
                      f"soak (paced): birth-to-swap grew {grew:.0f} ms over "
                      f"the run, more than one delta's service "
                      f"({out['service_ms_max']:.0f} ms): {out['delta_ms']}")
            if run == "stall":
                check(r["freshness_breached"] and r["freshness_recovered"],
                      f"soak (stall): serving_freshness breached and "
                      f"recovered ({r})")
                check(r["stalled_hop"] == "fetch",
                      f"soak (stall): the fetch hop dominates "
                      f"({r['hop_max_ms']})")
                check(r["timeline"]["chain_ok"] and r["timeline"]["chain"]
                      == ["birth", "commit", "publish", "fetch", "apply",
                          "swap", "first_predict"],
                      f"soak (stall): the last delta's chain ({r})")
                out.update({"stall_s": extra["stall_s"],
                            "freshness_threshold_ms":
                                extra["freshness_threshold_ms"],
                            "hop_max_ms": r["hop_max_ms"],
                            "timeline_chain": r["timeline"]["chain"]})
            rec[run] = out
            emit({"phase": "soak", "run": run, **out})
        check(len({rec[run]["collective_fingerprint"]
                   for run in ("plain", "quiet", "paced", "stall")}) == 1,
              "soak: the same collective fingerprint in every run")
        rec["launches"] = launches
        rec["wall_seconds"] = time.perf_counter() - t_phase
        emit({"phase": "soak", **rec})
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_demo(ops, smi: str) -> dict:
    """The serving demo at the flagship's widths -> {kernel: launches of
    the phase}. See the module docstring, item 22."""
    from openembedding_tpu_torch.examples import serving_demo
    from openembedding_tpu_torch.model import Trainer

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-demo-")
    try:
        ops.reset_launch_counts()
        with _spied_drivers(Trainer) as drivers:
            r = serving_demo.main([
                "--vocab", str(VOCAB), "--dim", str(DIM), "--hidden",
                ",".join(str(h) for h in SOAK_HIDDEN), "--batch",
                str(BATCH), "--workdir", tmp])
        ran = ran_launches(ops.launch_counts(),
                           [graph_record(d) for d in drivers])
        check(r["rows"].tobytes() == r["state_rows"].tobytes(),
              "demo: the REST pull answers the trained table's rows bit "
              "for bit")
        check(r["logits"].tobytes() == r["local_logits"].tobytes(),
              "demo: the REST predict answers the in-process "
              "StandaloneModel.predict bit for bit")
        check(np.isfinite(r["loss"]) and r["logits"].shape == (4,),
              f"demo: a finite loss and 4 logits ({r['loss']})")
        check(ran["gather_rows"] > 0 and ran["fused_sparse_apply"] > 0,
              f"demo: the gather and the apply ran ({ran})")
        emit({"phase": "demo", "card": smi, "loss": r["loss"],
              "rows_shape": list(r["rows_shape"]),
              "logits": r["logits"].tolist(), "launches": ran,
              "wall_seconds": time.perf_counter() - t_phase})
        return ran
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_keras(torch, mb, ops, smi: str) -> dict:
    """The Keras bridge on the card -> {kernel: launches of the phase}. See
    the module docstring, item 23. Without Keras it prints that it did not
    run and returns no launches."""
    import importlib.util
    zero = {k: 0 for k in KERNELS}
    if importlib.util.find_spec("keras") is None:
        emit({"phase": "keras", "ran": False, "why": "keras not installed"})
        return zero
    if "keras" not in sys.modules:
        os.environ["KERAS_BACKEND"] = "torch"
    import keras
    from openembedding_tpu_torch.keras_compat import (from_keras_model,
                                                      import_keras_rows)
    from openembedding_tpu_torch.model import Trainer

    t_phase = time.perf_counter()
    # a plain-Keras DeepFM of the flagship's widths: one table fed by a
    # 39-field id input, the FM term and the 400-400-400 tower
    ids_in = keras.Input(shape=(KERAS_FIELDS,), dtype="int32", name="ids")
    e = keras.layers.Embedding(VOCAB, DIM, name="emb")(ids_in)
    sum_vec = keras.layers.Lambda(lambda t: keras.ops.sum(t, axis=1))(e)
    sum_sq = keras.layers.Lambda(lambda t: keras.ops.sum(t * t, axis=1))(e)
    fm = keras.layers.Lambda(lambda t: 0.5 * keras.ops.sum(
        t[0] * t[0] - t[1], axis=-1, keepdims=True))([sum_vec, sum_sq])
    x = keras.layers.Flatten()(e)
    for width in SOAK_HIDDEN:
        x = keras.layers.Dense(width, activation="relu")(x)
    logit = keras.layers.Add()([fm, keras.layers.Dense(1)(x)])
    m = keras.Model(ids_in, keras.layers.Activation("sigmoid")(logit))
    m.compile(optimizer=keras.optimizers.Adagrad(learning_rate=0.05),
              loss="binary_crossentropy")
    emodel, opt = from_keras_model(m)
    tr = Trainer(emodel, opt, device="cuda")
    rng = np.random.default_rng(SEED + 23)
    batches = [{"sparse": {"ids": rng.integers(
        0, VOCAB, (BATCH, KERAS_FIELDS)).astype(np.int32)},
        "dense": None,
        "label": rng.integers(0, 2, BATCH).astype(np.float32)}
        for _ in range(KERAS_STEPS)]
    start = import_keras_rows(tr, tr.init(batches[0]), m)
    eager, graph = start.clone(), start.clone()
    ops.reset_launch_counts()
    eager_losses = []
    for b in batches:
        eager, out = tr.train_step(eager, b)
        eager_losses.append(out["loss"].clone())
    step = tr.jit_train_step()
    graph_losses = []
    for b in batches:
        graph, out = step(graph, b)
        graph_losses.append(out["loss"].clone())
    ran = ran_launches(ops.launch_counts(), [graph_record(step)])
    check(torch.equal(mb.bits(torch.stack(eager_losses)),
                      mb.bits(torch.stack(graph_losses))),
          "keras: the graph steps' losses equal the eager steps' bit for bit")
    for name in emodel.specs:
        a, b = eager.tables[name], graph.tables[name]
        check(torch.equal(mb.bits(a.weights), mb.bits(b.weights))
              and all(torch.equal(mb.bits(a.slots[s]), mb.bits(b.slots[s]))
                      for s in a.slots),
              f"keras: table {name} and its slots bit-equal")
    for (n, p), (_, q) in zip(eager.dense.named_parameters(),
                              graph.dense.named_parameters()):
        check(torch.equal(mb.bits(p.detach()), mb.bits(q.detach())),
              f"keras: dense leaf {n} bit-equal")
    check(ran["gather_rows"] >= 2 * KERAS_STEPS
          and ran["fused_sparse_apply"] >= 2 * KERAS_STEPS,
          f"keras: a gather and an apply a step each way ({ran})")
    emit({"phase": "keras", "ran": True, "card": smi,
          "losses": [float(v) for v in eager_losses], "launches": ran,
          "captures": step.captures,
          "wall_seconds": time.perf_counter() - t_phase})
    return ran


def phase_build(torch, kernel_modules, _build) -> None:
    """Build every kernel at the same time, one nvcc each."""
    t0 = time.perf_counter()
    errors = []

    def build(lib_fn):
        try:
            lib_fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(m._library,))
               for m in kernel_modules]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for m in kernel_modules:
        info = _build.BUILD_INFO[m.KERNEL]
        emit({"phase": "build", "kernel": m.KERNEL,
              "seconds": time.perf_counter() - t0,
              "nvcc_seconds": info["seconds"],
              "ptxas": [ln for ln in info["log"].splitlines()
                        if "Compiling entry" in ln or "registers" in ln
                        or "spill" in ln]})
    gather, gather_windows = kernel_modules[:2]
    lib = gather_windows._library()
    rule = (lib.oe_window_gather_tile(), lib.oe_window_gather_stage_bytes(),
            lib.oe_window_gather_stage_min_rows())
    check(rule == (gather_windows.TILE, gather_windows.STAGE_BYTES,
                   gather_windows.STAGE_MIN_ROWS),
          f"the window kernel's staging rule {rule} is the one "
          "ops/gather_windows.staged_bytes mirrors")
    glib = gather._library()
    emit({"phase": "build", "gather_rows_grid_blocks": {
        f"{wb}-byte words, {ib}-byte ids":
        glib.oe_gather_rows_resident_blocks(wb, ib)
        for wb in (16, 8, 4, 2) for ib in (4, 8)}})
    apply = kernel_modules[2]
    alib = apply._library()
    emit({"phase": "build", "fused_sparse_apply_grid_blocks": {
        f"rule {rule}, {eb}-byte table, E {e}":
        alib.oe_fused_sparse_apply_resident_blocks(rule, eb, e)
        for rule in range(len(apply.WIDE_SLOTS)) for eb in (4, 2)
        for e in apply.WORD_ELEMS}})
    plans = apply_plan_cases(apply)
    emit({"phase": "build", "fused_sparse_apply_plans_checked": plans})


def apply_plan_cases(apply) -> int:
    """`ops/apply.launch_plan` against the kernel's own plan
    (`oe_fused_sparse_apply_plan`, which reads addresses and strides and
    nothing they point to) for every rule, widths from 1 to 1024, both
    table types, and each array in turn moved 2, 4 or 8 bytes off a
    16-byte boundary or given an odd or even row stride; returns the cases
    checked."""
    base = 1 << 20
    cases = 0
    for rule, wide in enumerate(apply.WIDE_SLOTS):
        for dim in (1, 2, 3, 4, 9, 10, 11, 12, 16, 64, 65, 128, 1024):
            for eb in (4, 2):
                def arrays(which=-1, off=0, stride_add=0):
                    out = []
                    for k in range(wide + 2):
                        bytes_ = eb if k == 0 else 4
                        addr = base * (k + 1) + (off if k == which else 0)
                        out.append((addr, dim + (stride_add if k == which
                                                 else 0), bytes_))
                    return out
                variants = [arrays()]
                for which in range(wide + 2):
                    variants += [arrays(which, off) for off in (2, 4, 8)
                                 if off % (eb if which == 0 else 4) == 0]
                    variants += [arrays(which, 0, add) for add in (1, 2)]
                for arrs in variants:
                    want = apply.kernel_plan(rule, dim, arrs)
                    got = apply.launch_plan(rule, dim, arrs)
                    check((got.word_elems, got.tile_rows) == want,
                          f"ops/apply.launch_plan {got} is the kernel's "
                          f"plan {want} (rule {rule}, width {dim}, arrays "
                          f"{arrs})")
                    cases += 1
    return cases


def phase_microbench(torch, mb, ops) -> tuple:
    """The micro-benchmark at full size; -> (its records, the launches that
    ran: its train step's graph counted as it replayed, not as captured)."""
    ops.reset_launch_counts()  # the path's run: counts read just after
    records = mb.main([])
    graphs = [r for r in records if "graph_launches" in r]
    check(len(graphs) == 1, "the micro-benchmark ran one graph driver")
    launches = ran_launches(ops.launch_counts(), graphs)
    for k in KERNELS:
        check(launches[k] > 0, f"the micro-benchmark launched {k}")
    emit({"phase": "microbench", "records": len(records),
          "launches": launches, "graph": {k: graphs[0][k] for k in (
              "captures", "replays", "graph_launches")}})
    return records, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from openembedding_tpu_torch import data, microbench as mb, optimizers
    from openembedding_tpu_torch import ops
    from openembedding_tpu_torch.ops import (_build, apply, gather,
                                             gather_windows, hash_probe,
                                             sparse)
    phase_build(torch, (gather, gather_windows, apply, hash_probe), _build)

    main_gather = phase_kernel(torch, mb, gather)
    main_windows, profile_calls = phase_windows(
        torch, mb, gather, gather_windows, sparse, data)
    torch.cuda.empty_cache()
    main_apply, apply_calls = phase_apply(torch, mb, apply, gather, sparse,
                                          optimizers, data)
    kernels_profile(torch, "windows", profile_calls, "window_gather")
    kernels_profile(torch, "apply", apply_calls, "fused_apply")
    del profile_calls, apply_calls
    torch.cuda.empty_cache()
    serve_launches = phase_serve(torch, ops, gather)
    train = phase_train(torch, mb, ops, optimizers, data)
    torch.cuda.empty_cache()
    example = phase_example(torch, mb, ops, data, optimizers)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke-tsv-")
    try:
        # the example phase's TSV again (same seed), for the later phases
        tsv = os.path.join(tmp, "day.tsv")
        write_criteo_tsv(tsv, EXAMPLE_BATCHES * BATCH, SEED + 3)
        # the array flagship's graph step: through the entry point on the
        # TSV (the reader's pace) and on batches in memory (train phase)
        array_graph = next(
            {k: r[k] for k in ("steady_ms_per_step", "device_ms_per_step",
                               "device_idle_share")}
            for r in example["runs"] if r["run"] == "graph")
        array_graph["in_memory"] = {
            "ms_per_step": train["graph_step_ms"],
            "device_ms_per_step":
                train["graph_step_profile"]["profile_device_ms_per_step"],
            "idle_share": train["graph_step_profile"][
                "device_idle_share_unprofiled"]}
        probe = phase_hash_probe(torch, mb, ops)
        torch.cuda.empty_cache()
        hash_launches = phase_hash(torch, mb, ops, data, optimizers, tsv,
                                   array_graph)
        torch.cuda.empty_cache()
        lr_launches = phase_lr_example(torch, mb, ops)
        torch.cuda.empty_cache()
        zoo_launches = phase_zoo(torch, mb, ops, data, tsv)
        torch.cuda.empty_cache()
        mesh_launches = phase_mesh(torch, mb, ops, data, optimizers, tsv,
                                   array_graph)
        torch.cuda.empty_cache()
        persist_launches = phase_persist(torch, mb, ops, data, optimizers,
                                         tsv)
        torch.cuda.empty_cache()
        offload_launches = phase_offload(torch, mb, ops, data, optimizers,
                                         tsv, smi)
        torch.cuda.empty_cache()
        seq_launches = phase_seq(torch, mb, ops, optimizers, smi)
        torch.cuda.empty_cache()
        obs_launches = phase_obs(torch, mb, ops, data, optimizers, tsv, smi)
        torch.cuda.empty_cache()
        placement_launches = phase_placement(torch, smi)
        torch.cuda.empty_cache()
        sync_launches = phase_sync(torch, mb, ops, data, optimizers, smi)
        torch.cuda.empty_cache()
        shard_launches = phase_shard(torch, mb, ops, data, optimizers, smi)
        torch.cuda.empty_cache()
        ingest_launches = phase_ingest(torch, mb, ops, data, optimizers,
                                       smi)
        torch.cuda.empty_cache()
        soak_launches = phase_soak(ops, smi)
        torch.cuda.empty_cache()
        demo_launches = phase_demo(ops, smi)
        torch.cuda.empty_cache()
        keras_launches = phase_keras(torch, mb, ops, smi)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _, bench_launches = phase_microbench(torch, mb, ops)
    by_path = {k: {"serve": serve_launches if k == "gather_rows" else 0,
                   "train": train["launches"][k],
                   "train_graphs": train["graph_launches"][k],
                   "example": example["launches"][k],
                   "hash": hash_launches[k],
                   "lr_example": lr_launches[k],
                   "zoo": zoo_launches[k],
                   "mesh": mesh_launches[k],
                   "persist": persist_launches[k],
                   "offload": offload_launches[k],
                   "seq": seq_launches[k],
                   "obs": obs_launches[k],
                   "placement": placement_launches[k],
                   "sync": sync_launches[k],
                   "shard": shard_launches[k],
                   "ingest": ingest_launches[k],
                   "soak": soak_launches[k],
                   "demo": demo_launches[k],
                   "keras": keras_launches[k],
                   "microbench": bench_launches[k]} for k in KERNELS}
    # the keras phase runs only where Keras is installed (it says so)
    paths = ("hash", "lr_example", "zoo", "mesh", "persist", "offload",
             "seq", "obs", "placement", "sync", "shard", "ingest", "soak",
             "demo") + (("keras",) if any(keras_launches.values()) else ())
    for path in paths:
        for k in ("gather_rows", "fused_sparse_apply"):
            check(by_path[k][path] > 0, f"the {path} phase launched {k}")
    rows = [("gather_rows", "gather_rows.cu", ":148", main_gather),
            ("gather_rows_windows", "gather_rows_windows.cu", ":282",
             main_windows),
            ("fused_sparse_apply", "fused_sparse_apply.cu", ":464",
             main_apply)]
    emit({"kernels": [{
        "name": k, "route": "cuda",
        "source": f"openembedding_tpu_torch/csrc/{src}",
        "replaces": f"openembedding_tpu/ops/pallas_sparse.py{line}",
        "launches": sum(by_path[k].values()),
        "launches_by_path": by_path[k],
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"], "bound_by": "bytes",
        "library_ms": rec["library_ms"]} for k, src, line, rec in rows] + [{
        "name": "hash_probe", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/hash_probe.cu",
        "replaces": "none: jnp, openembedding_tpu/tables/hash_table.py"
                    ":268-330",
        "launches_hash": hash_launches["hash_walk"],
        "ms": probe["steady"]["ms"], "plain_ms": probe["steady"]["plain_ms"],
        "bound_ms": probe["steady"]["bound_ms"], "bound_by": "sectors",
        "first_pass_ms_mean": probe["first_pass"]["kernel_ms_mean"],
        "all_new_ms": probe["all_new"]["ms"],
        "all_new_plain_ms": probe["all_new"]["plain_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
