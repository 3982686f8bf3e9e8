// Window-batched row gather: out[i, :] = w[rows[i], :] for in-range ids,
// +0.0 rows for the others, computed by staging fixed-grid windows of
// `window` consecutive table rows in shared memory.
//
// Replaces the TPU kernel
// `openembedding_tpu/ops/pallas_sparse.py::gather_rows_windows`
// (`_window_gather_kernel` / `_window_gather_call`). That kernel takes a
// prepass's scalars (per block of requested rows: the distinct windows'
// base rows, their count, and each row's slot*W + offset), DMAs each
// distinct window of the block into VMEM once, then copies every requested
// row out of its staged window. The prepass is ported as torch ops
// (`ops/gather_windows.window_prepass`); this file is the kernel.
//
// What bounds it on an H100: memory. It does no arithmetic. The function
// itself needs n rows read and n rows written, but the staging reads whole
// windows: for ids spread over a large table every row brings its own
// window, W times the row's bytes (the TPU kernel's documented negative
// result, `pallas_sparse.py:204-209`). For dense ids (many requested rows
// in one window) the staging reads fewer bytes than a per-row gather would
// touch in sectors.
//
// What the design does about it:
// - One CTA per block of requested rows (the TPU grid step). The VMEM of the
//   TPU held all of a block's windows at once; 227 KB of shared memory does
//   not (256 windows x 16 rows x 40 B is 160 KB, at width 64 it is 1 MB), so
//   the CTA loops over chunks of its distinct windows that fit: stage a
//   chunk, sync, copy out the rows whose window is in the chunk, sync.
// - A window is W * row_bytes contiguous bytes, so the staging loads
//   coalesce; each thread keeps kUnroll loads in flight before it stores
//   them, so a CTA has thousands of loads outstanding.
// - Rows move as raw words (16, 8, 4 or 2 bytes, the widest that divides
//   the row and the table's address), so bfloat16 rows move bit-exact.
// - The prepass marks out-of-range ids with slotoff -1; the kernel writes
//   their zero rows itself (the TPU version masked afterwards with
//   `jnp.where`).
// - A CTA uses at most half the card's opt-in shared memory when a window
//   fits in that, so two CTAs share an SM and one stages while the other
//   copies out. The opt-in limit is set once per device
//   (`oe_window_gather_init`), not per launch.
// - Table offsets are 64-bit (base row * row words).
//
// Plain C interface (bound with ctypes in `ops/gather_windows.py`): the
// launch goes on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

int g_smem_optin = 0;  // bytes of dynamic shared memory a block may use

template <typename Word>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const Word* __restrict__ w, int row_words,
                     const int64_t* __restrict__ bases,
                     const int32_t* __restrict__ nw,
                     const int32_t* __restrict__ slotoff, int64_t n,
                     int block, int window, int chunk,
                     Word* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Word* stage = reinterpret_cast<Word*>(smem_raw);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * block;
  const int64_t left = n - row0;
  const int rows_here = left < block ? static_cast<int>(left) : block;
  const int64_t* blk_bases = bases + row0;
  const int32_t* blk_slotoff = slotoff + row0;
  const int nwin = nw[blockIdx.x];
  const int win_words = window * row_words;

  for (int c0 = 0; c0 < nwin; c0 += chunk) {
    const int cn = nwin - c0 < chunk ? nwin - c0 : chunk;
    // stage windows c0 .. c0+cn-1 of this block, kUnroll loads in flight
    const int total = cn * win_words;
    for (int e0 = threadIdx.x; e0 < total; e0 += kUnroll * kThreads) {
      Word v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) {
          const int k = e / win_words;
          const int off = e - k * win_words;
          v[u] = w[blk_bases[c0 + k] * row_words + off];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kThreads;
        if (e < total) stage[e] = v[u];
      }
    }
    __syncthreads();
    // copy out every row whose window is in this chunk; out-of-range ids
    // (slotoff -1) take a zero row, written once, with the first chunk
    const int emit = rows_here * row_words;
    for (int e = threadIdx.x; e < emit; e += kThreads) {
      const int i = e / row_words;
      const int col = e - i * row_words;
      const int so = blk_slotoff[i];
      Word* dst = out + (row0 + i) * row_words + col;
      if (so < 0) {
        if (c0 == 0) *dst = Word{};
        continue;
      }
      const int slot = so / window;
      if (slot >= c0 && slot < c0 + cn) {
        const int r = so - slot * window;
        *dst = stage[(slot - c0) * win_words + r * row_words + col];
      }
    }
    __syncthreads();
  }
}

template <typename Word>
int launch(const void* w, int64_t row_bytes, const int64_t* bases,
           const int32_t* nw, const int32_t* slotoff, int64_t n, int block,
           int window, void* out, cudaStream_t stream) {
  const int row_words = static_cast<int>(row_bytes / sizeof(Word));
  const int64_t win_bytes = static_cast<int64_t>(window) * row_bytes;
  int64_t budget = g_smem_optin / 2;
  if (win_bytes > budget) budget = g_smem_optin;
  int64_t chunk = budget / win_bytes;
  if (chunk > block) chunk = block;
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nb = (n + block - 1) / block;
  const size_t smem = static_cast<size_t>(chunk * win_bytes);
  window_gather_kernel<Word><<<static_cast<unsigned>(nb), kThreads, smem,
                               stream>>>(
      static_cast<const Word*>(w), row_words, bases, nw, slotoff, n, block,
      window, static_cast<int>(chunk), static_cast<Word*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

template <typename Word>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(window_gather_kernel<Word>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

// Sets the kernels' dynamic shared memory limit to the current device's
// opt-in maximum. Call once per device before the first launch on it.
int oe_window_gather_init() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = allow_smem<uint4>(optin)) != cudaSuccess ||
      (err = allow_smem<uint2>(optin)) != cudaSuccess ||
      (err = allow_smem<uint32_t>(optin)) != cudaSuccess ||
      (err = allow_smem<uint16_t>(optin)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  g_smem_optin = optin;
  return static_cast<int>(cudaSuccess);
}

// Bytes of shared memory a block may use (0 before oe_window_gather_init).
int oe_window_gather_smem_bytes() { return g_smem_optin; }

// w: the table, rows of row_bytes bytes (a multiple of 2); bases: nb*block
// int64 window base rows per block slot; nw: nb int32 distinct-window
// counts; slotoff: nb*block int32 slot*window + offset per requested row,
// -1 for an out-of-range id; out: n rows. Returns a cudaError_t.
int oe_gather_rows_windows(const void* w, int64_t row_bytes,
                           const int64_t* bases, const int32_t* nw,
                           const int32_t* slotoff, int64_t n, int block,
                           int window, void* out, void* stream) {
  if (g_smem_optin <= 0 || row_bytes <= 0 || row_bytes % 2 != 0 || n < 0 ||
      block <= 0 || window <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest word that divides the row and both base addresses
  if (row_bytes % 16 == 0 && aligned(w, 16) && aligned(out, 16)) {
    return launch<uint4>(w, row_bytes, bases, nw, slotoff, n, block, window,
                         out, s);
  }
  if (row_bytes % 8 == 0 && aligned(w, 8) && aligned(out, 8)) {
    return launch<uint2>(w, row_bytes, bases, nw, slotoff, n, block, window,
                         out, s);
  }
  if (row_bytes % 4 == 0 && aligned(w, 4) && aligned(out, 4)) {
    return launch<uint32_t>(w, row_bytes, bases, nw, slotoff, n, block,
                            window, out, s);
  }
  return launch<uint16_t>(w, row_bytes, bases, nw, slotoff, n, block, window,
                          out, s);
}

const char* oe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
