// Window-batched row gather: out[i, :] = w[rows[i], :] for in-range ids,
// +0.0 rows for the others; ids that share a window of `window` table rows
// may be read as one span.
//
// Replaces the TPU kernel
// `openembedding_tpu/ops/pallas_sparse.py::gather_rows_windows`
// (`_window_gather_kernel` / `_window_gather_call`). That kernel takes a
// prepass's scalars (per block of requested rows: the distinct fixed-grid
// windows, their count, each row's slot*W + offset), DMAs each distinct
// window of the block into VMEM once, then copies every row out of its
// window. The TPU needed the windows because it paid about 300 ns of
// scalar-core descriptor issue per row DMA (`pallas_sparse.py:189-209`).
//
// What bounds it on an H100: memory, as for the per-row gather
// (`gather_rows.cu`). The card has no per-row descriptor cost, and its
// memory system merges the sorted, adjacent rows that one warp reads on
// its own; bytes staged beyond the requested rows' sectors are pure loss.
//
// What the design does about it: one launch, no prepass.
// - One CTA per tile of `block` consecutive requested ids (the TPU's grid
//   step, at most kTile), one id a thread, loaded coalesced.
// - Runs instead of a sort: a run is a maximal stretch of consecutive
//   positions whose in-range ids lie in one fixed window (`id / window`);
//   an out-of-range id ends a run. Run starts come from an adjacent
//   compare, run numbers from a block-wide scan (`__ballot_sync` + warp
//   counts), each run's least and greatest row from shared-memory atomics.
//   For sorted ids the runs are the JAX prepass's distinct windows of the
//   block; for ids in any order they are shorter, and the answer is the
//   same.
// - A dense run is staged: it has at least kStageMinRows positions, and
//   they are at least `share` of the rows from its least to its greatest
//   requested row (`share` is the caller's; `ops/gather_windows.py`
//   holds the default). Staging is one
//   1-D TMA bulk copy (`cp.async.bulk`, completion on an mbarrier) of that
//   span only, widened to 16-byte boundaries and only if the widened span
//   lies inside the table, into a kStageBytes buffer; runs are placed in
//   order and one that would overflow the buffer is not staged. The staged
//   rows then move out of shared memory.
// - Every other row takes the row-copy core's direct path
//   (`gather_core.cuh`) while the bulk copies are in flight: ids read once
//   per row and passed by `__shfl_sync`, no division per element, the
//   widest word that divides the row bytes and both base addresses, all of
//   a lane's loads before its stores, streaming stores.
// - A rule that stages nothing (share = inf, the default since the card
//   measured staging slower than the direct path at every density) skips
//   the run analysis: every row goes the direct way at once.
// - The staging buffer is static shared memory below 48 KB, so no launch
//   attribute is set, and nothing is queried per launch: a launch can be
//   captured into a CUDA graph.
// `ops/gather_windows.staged_bytes` applies the same run and staging rule
// to ids on the host, to report what a launch stages.
//
// Plain C interface (bound with ctypes in `ops/gather_windows.py`): the
// launch goes on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <climits>
#include <cmath>

#include "gather_core.cuh"

namespace {

using namespace oe_gather;

constexpr int kTile = 256;          // ids a CTA takes at most, one a thread
constexpr int kStageBytes = 32768;  // shared memory for staged runs
constexpr int kStageMinRows = 2;    // a run of one row is never staged
constexpr int kNotStaged = INT_MIN;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename Word, typename Id>
__global__ void __launch_bounds__(kTile)
window_gather_kernel(const Word* __restrict__ w, int64_t n_rows,
                     int64_t row_bytes, RowMap m,
                     const Id* __restrict__ rows, int64_t n, int tile,
                     int64_t window, int shift, bool runs, double share,
                     Word* __restrict__ out) {
  __shared__ __align__(16) unsigned char stage[kStageBytes];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int64_t s_win[kTile + 1];  // window per position, -1: none
  __shared__ int s_lo[kTile];           // per run: least row - window base
  __shared__ int s_hi[kTile];           // per run: greatest row - its base
  __shared__ int s_end[kTile];          // per run: one past its last position
  __shared__ int s_key[kTile];          // per run: staged key of the window
                                        // base, or kNotStaged
  __shared__ int s_warp[kTile / 32];
  __shared__ int s_total;               // bytes staged

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wp = t >> 5;
  const int64_t pos0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t left = n - pos0;
  const int here = left < tile ? static_cast<int>(left) : tile;

  int64_t r = -1;
  bool ok = false;
  if (t < here) {
    r = static_cast<int64_t>(rows[pos0 + t]);
    ok = r >= 0 && r < n_rows;
  }
  const int warp_rows = here - wp * 32 < 32 ? here - wp * 32 : 32;
  const Cursor start = first_word(m);
  Word* warp_out = out + (pos0 + wp * 32) * m.rw;
  if (!runs) {  // the rule stages nothing: no run analysis, all rows direct
    if (warp_rows > 0) {
      copy_tile(ok ? r * m.rw : kZero, warp_rows, m, start, warp_out,
                TableRows<Word>{w});
    }
    return;
  }
  const int64_t win = ok ? (shift >= 0 ? r >> shift : r / window) : -1;
  s_win[t] = win;
  s_lo[t] = INT_MAX;
  s_hi[t] = -1;
  if (t == 0) {
    s_win[blockDim.x] = -1;
    s_total = 0;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_addr(&bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // run numbers: a run starts where the window changes
  const bool first = ok && (t == 0 || s_win[t - 1] != win);
  const bool last = ok && s_win[t + 1] != win;
  const unsigned starts = __ballot_sync(kFull, first);
  if (lane == 0) s_warp[wp] = __popc(starts);
  __syncthreads();
  int before = 0;
  for (int i = 0; i < wp; ++i) before += s_warp[i];
  const int run = before + __popc(starts & ((2u << lane) - 1u)) - 1;
  const int off = ok ? static_cast<int>(r - win * window) : 0;
  if (ok) {
    atomicMin(&s_lo[run], off);
    atomicMax(&s_hi[run], off);
  }
  if (last) s_end[run] = t + 1;
  __syncthreads();

  // each run's first thread decides whether it stages, and its bytes
  const uintptr_t table = reinterpret_cast<uintptr_t>(w);
  uintptr_t lo = 0;
  int bytes = 0;
  if (first) {
    const int count = s_end[run] - t;
    const int64_t base = win * window;
    const int64_t span = s_hi[run] - s_lo[run] + 1;
    if (count >= kStageMinRows &&
        static_cast<double>(count) >= share * static_cast<double>(span)) {
      lo = (table + (base + s_lo[run]) * row_bytes) & ~uintptr_t{15};
      const uintptr_t hi =
          (table + (base + s_hi[run] + 1) * row_bytes + 15) & ~uintptr_t{15};
      if (lo >= table && hi <= table + n_rows * row_bytes &&
          hi - lo <= kStageBytes) {
        bytes = static_cast<int>(hi - lo);
      }
    }
  }
  // exclusive scan of the bytes over the block, in position order
  int incl = bytes;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[wp] = incl;  // all read s_warp before the sync above
  __syncthreads();
  int excl = incl - bytes;
  for (int i = 0; i < wp; ++i) excl += s_warp[i];
  const bool staged = bytes > 0 && excl + bytes <= kStageBytes;
  if (first) {
    // key of the window's base row in the buffer, in words: rows below the
    // span are never read through it
    const int64_t key_bytes = excl + static_cast<int64_t>(
        table + win * window * row_bytes - lo);
    s_key[run] = staged ? static_cast<int>(
        key_bytes / static_cast<int64_t>(sizeof(Word)))
                        : kNotStaged;
    if (staged) atomicMax(&s_total, excl + bytes);
  }
  __syncthreads();
  const int total = s_total;
  if (total > 0) {
    if (t == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_addr(&bar)), "r"(total) : "memory");
    }
    __syncthreads();
    if (staged) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(stage + excl)), "l"(lo), "r"(bytes),
          "r"(smem_addr(&bar)) : "memory");
    }
  }

  // the direct rows while the spans are in flight, then the staged ones
  long long direct = kSkip;
  long long from_stage = kSkip;
  if (t < here) {
    if (!ok) {
      direct = kZero;
    } else if (s_key[run] == kNotStaged) {
      direct = r * m.rw;
    } else {
      from_stage = s_key[run] + static_cast<long long>(off) * m.rw;
    }
  }
  if (warp_rows > 0 && __any_sync(kFull, direct != kSkip)) {
    copy_tile(direct, warp_rows, m, start, warp_out, TableRows<Word>{w});
  }
  if (total > 0) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred p;"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
          " selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(smem_addr(&bar)), "r"(0u) : "memory");
    }
    if (warp_rows > 0 && __any_sync(kFull, from_stage != kSkip)) {
      copy_tile(from_stage, warp_rows, m, start, warp_out,
                StagedRows<Word>{reinterpret_cast<const Word*>(stage)});
    }
  }
}

template <typename Word, typename Id>
int launch(const void* w, int64_t n_rows, int64_t row_bytes,
           const void* rows, int64_t n, int tile, int64_t window,
           double share, void* out, cudaStream_t stream) {
  int shift = -1;
  if ((window & (window - 1)) == 0) {
    shift = 0;
    while ((int64_t{1} << shift) < window) ++shift;
  }
  const int rw = static_cast<int>(row_bytes / sizeof(Word));
  const int64_t blocks = (n + tile - 1) / tile;
  const int threads = (tile + 31) / 32 * 32;
  window_gather_kernel<Word, Id><<<static_cast<unsigned>(blocks), threads,
                                   0, stream>>>(
      static_cast<const Word*>(w), n_rows, row_bytes, row_map(rw),
      static_cast<const Id*>(rows), n, tile, window, shift,
      !(std::isinf(share) && share > 0), share, static_cast<Word*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename Word>
int launch_word(const void* w, int64_t n_rows, int64_t row_bytes,
                const void* rows, int id_bytes, int64_t n, int tile,
                int64_t window, double share, void* out,
                cudaStream_t stream) {
  if (id_bytes == 8) {
    return launch<Word, int64_t>(w, n_rows, row_bytes, rows, n, tile, window,
                                 share, out, stream);
  }
  return launch<Word, int32_t>(w, n_rows, row_bytes, rows, n, tile, window,
                               share, out, stream);
}

}  // namespace

extern "C" {

// Ids a CTA takes at most, the staging buffer's bytes and the fewest
// positions a staged run has (`ops/gather_windows.py` mirrors the rule).
int oe_window_gather_tile() { return kTile; }
int oe_window_gather_stage_bytes() { return kStageBytes; }
int oe_window_gather_stage_min_rows() { return kStageMinRows; }

// w: n_rows rows of row_bytes bytes (a multiple of 2); rows: n int32
// (id_bytes 4) or int64 (id_bytes 8) ids; tile: ids per CTA, 1..kTile;
// window: rows per window, >= 1; share: a run stages when its positions
// are at least share x the rows of its span (inf: none stages); out: n
// rows. Returns a cudaError_t.
int oe_gather_rows_windows(const void* w, int64_t n_rows, int64_t row_bytes,
                           const void* rows, int id_bytes, int64_t n,
                           int tile, int64_t window, double share, void* out,
                           void* stream) {
  if (row_bytes <= 0 || row_bytes % 2 != 0 || n < 0 || n_rows < 0 ||
      tile < 1 || tile > kTile || window < 1 ||
      (id_bytes != 4 && id_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes(row_bytes, w, out)) {
    case 16:
      return launch_word<uint4>(w, n_rows, row_bytes, rows, id_bytes, n, tile,
                                window, share, out, s);
    case 8:
      return launch_word<uint2>(w, n_rows, row_bytes, rows, id_bytes, n, tile,
                                window, share, out, s);
    case 4:
      return launch_word<uint32_t>(w, n_rows, row_bytes, rows, id_bytes, n,
                                   tile, window, share, out, s);
    default:
      return launch_word<uint16_t>(w, n_rows, row_bytes, rows, id_bytes, n,
                                   tile, window, share, out, s);
  }
}

const char* oe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
