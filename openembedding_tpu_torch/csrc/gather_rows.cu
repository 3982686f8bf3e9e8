// Row gather for embedding tables: out[i, :] = w[rows[i], :] when
// 0 <= rows[i] < n_rows and valid[i] (if a mask is given), else +0.0.
//
// Replaces the TPU kernel `openembedding_tpu/ops/pallas_sparse.py::gather_rows`
// (`_gather_kernel` / `_gather_call`). That kernel streams each requested row
// from HBM into VMEM with one DMA per row, a ring of 8 DMAs in flight, and
// masks afterwards (it loads from a clamped index, then `jnp.where`s).
//
// What bounds it on an H100: memory, and within memory, latency. The gather
// does no arithmetic; it moves n * row bytes of table rows in, the same out,
// plus the ids and the mask. Rows are short (40 bytes at the flagship width
// of 10 float32 columns) and randomly placed, so each row read touches one
// or two 32-byte sectors, and the time is that of the dependent chain id
// load -> row load -> store unless many row loads are in flight at once.
//
// What the design does about it (the row-copy core, `gather_core.cuh`):
// - One warp takes a tile of consecutive ids (32, or fewer for rows wider
//   than 8 words a lane), loads them coalesced, one a lane, range-checks
//   each (and its mask) once, and multiplies it into a 64-bit table offset;
//   invalid rows are never loaded and get +0.0 words. The lanes that copy a
//   row get its offset with `__shfl_sync`.
// - Lanes map to (row, word) by a cursor with per-launch constants: no
//   division per element, 32-bit index math inside a tile.
// - Rows move in the widest word (16, 8, 4 or 2 bytes) that divides the row
//   bytes and both base addresses: 8 bytes at width 10 float32, 16 at
//   widths 64 and 128.
// - Each lane issues all of a tile's row loads (up to 8) before any store.
// - The grid is what the card holds at once: SMs x resident blocks per SM,
//   read once per device when the library loads (`oe_gather_rows_init`), and
//   each warp loops over tiles. Nothing is queried per launch, so a launch
//   can be captured into a CUDA graph.
// - Stores stream (`st.global.cs`) past L2, which keeps the hot rows.
//
// Plain C interface (bound from Python with ctypes in `ops/gather.py`): the
// launch goes on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include "gather_core.cuh"

namespace {

using namespace oe_gather;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int kInstances = 8;  // 4 word widths x 2 id widths

// resident blocks of each instance on each device; 0 until initialised
int g_blocks[kMaxDevices][kInstances];

template <typename Word, typename Id>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Word* __restrict__ w, int64_t n_rows, RowMap m,
                   int tile, int64_t tiles, const Id* __restrict__ rows,
                   const uint8_t* __restrict__ valid, int64_t n,
                   Word* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const Cursor start = first_word(m);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       t < tiles; t += stride) {
    const int64_t row0 = t * tile;
    const int64_t left = n - row0;
    const int here = left < tile ? static_cast<int>(left) : tile;
    long long key = kZero;
    if (lane < here) {
      const int64_t r = static_cast<int64_t>(rows[row0 + lane]);
      if (r >= 0 && r < n_rows && (valid == nullptr || valid[row0 + lane])) {
        key = r * m.rw;
      }
    }
    copy_tile(key, here, m, start, out + row0 * m.rw, TableRows<Word>{w});
  }
}

template <typename Word, typename Id>
constexpr int instance() {
  return (sizeof(Word) == 16 ? 0 : sizeof(Word) == 8 ? 1
          : sizeof(Word) == 4 ? 2 : 3) * 2 + (sizeof(Id) == 8 ? 1 : 0);
}

template <typename Word, typename Id>
cudaError_t init_one(int dev, int sms) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_rows_kernel<Word, Id>, kThreads, 0);
  if (err != cudaSuccess) return err;
  g_blocks[dev][instance<Word, Id>()] = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <typename Word>
cudaError_t init_word(int dev, int sms) {
  const cudaError_t err = init_one<Word, int32_t>(dev, sms);
  return err != cudaSuccess ? err : init_one<Word, int64_t>(dev, sms);
}

template <typename Word, typename Id>
int launch(int dev, const void* w, int64_t n_rows, int64_t row_bytes,
           const void* rows, const void* valid, int64_t n, void* out,
           cudaStream_t stream) {
  const int resident = g_blocks[dev][instance<Word, Id>()];
  if (resident <= 0) return static_cast<int>(cudaErrorInitializationError);
  const int rw = static_cast<int>(row_bytes / sizeof(Word));
  const int tile = tile_rows(rw);
  const int64_t tiles = (n + tile - 1) / tile;
  const int64_t want = (tiles + kWarps - 1) / kWarps;
  const int blocks = want < resident ? static_cast<int>(want) : resident;
  gather_rows_kernel<Word, Id><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Word*>(w), n_rows, row_map(rw), tile, tiles,
      static_cast<const Id*>(rows), static_cast<const uint8_t*>(valid), n,
      static_cast<Word*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename Word>
int launch_word(int dev, const void* w, int64_t n_rows, int64_t row_bytes,
                const void* rows, int id_bytes, const void* valid, int64_t n,
                void* out, cudaStream_t stream) {
  if (id_bytes == 8) {
    return launch<Word, int64_t>(dev, w, n_rows, row_bytes, rows, valid, n,
                                 out, stream);
  }
  return launch<Word, int32_t>(dev, w, n_rows, row_bytes, rows, valid, n,
                               out, stream);
}

}  // namespace

extern "C" {

// Reads the current device's SM count and each instance's resident blocks
// per SM. Call once per device, before the first launch on it and never
// inside a graph capture. Returns a cudaError_t.
int oe_gather_rows_init() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = init_word<uint4>(dev, sms)) != cudaSuccess ||
      (err = init_word<uint2>(dev, sms)) != cudaSuccess ||
      (err = init_word<uint32_t>(dev, sms)) != cudaSuccess ||
      (err = init_word<uint16_t>(dev, sms)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The most blocks a launch takes on the current device (SMs x resident
// blocks per SM) for this word and id width; 0 before oe_gather_rows_init.
int oe_gather_rows_resident_blocks(int word_bytes, int id_bytes) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 0;
  }
  const int w = word_bytes == 16 ? 0 : word_bytes == 8 ? 1
                : word_bytes == 4 ? 2 : 3;
  return g_blocks[dev][w * 2 + (id_bytes == 8 ? 1 : 0)];
}

// elem_bytes: 4 (float32) or 2 (bfloat16); id_bytes: 4 (int32) or 8 (int64);
// valid: a uint8/bool mask of n entries, or NULL. Launches on the current
// device, which oe_gather_rows_init has seen. Returns a cudaError_t.
int oe_gather_rows(const void* w, int64_t n_rows, int64_t dim, int elem_bytes,
                   const void* rows, int id_bytes, const void* valid,
                   int64_t n, void* out, void* stream) {
  if ((elem_bytes != 2 && elem_bytes != 4) || (id_bytes != 4 && id_bytes != 8)
      || n < 0 || dim < 0 || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n * dim == 0) {
    return static_cast<int>(cudaSuccess);
  }
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t row_bytes = dim * elem_bytes;
  switch (word_bytes(row_bytes, w, out)) {
    case 16:
      return launch_word<uint4>(dev, w, n_rows, row_bytes, rows, id_bytes,
                                valid, n, out, s);
    case 8:
      return launch_word<uint2>(dev, w, n_rows, row_bytes, rows, id_bytes,
                                valid, n, out, s);
    case 4:
      return launch_word<uint32_t>(dev, w, n_rows, row_bytes, rows, id_bytes,
                                   valid, n, out, s);
    default:
      return launch_word<uint16_t>(dev, w, n_rows, row_bytes, rows, id_bytes,
                                   valid, n, out, s);
  }
}

const char* oe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
