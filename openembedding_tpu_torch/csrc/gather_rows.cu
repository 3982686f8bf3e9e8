// Row gather for embedding tables: out[i, :] = w[rows[i], :] when
// 0 <= rows[i] < n_rows and valid[i] (if a mask is given), else +0.0.
//
// Replaces the TPU kernel `openembedding_tpu/ops/pallas_sparse.py::gather_rows`
// (`_gather_kernel` / `_gather_call`). That kernel streams each requested row
// from HBM into VMEM with one DMA per row, a ring of 8 DMAs in flight, and
// masks afterwards (it loads from a clamped index, then `jnp.where`s).
//
// What bounds it on an H100: memory. The gather does no arithmetic; it moves
// n*dim*itemsize bytes of table rows in, the same out, plus the ids and the
// mask. Rows are short (40 bytes at the flagship width of 10 float32 columns)
// and randomly placed, so each row read touches one or two 32-byte sectors
// and the work is latency-bound per row unless many loads are in flight.
//
// What the design does about it: a grid-stride loop over the n*dim output
// elements, one element per thread per iteration. Neighbouring threads read
// neighbouring columns of a row and write neighbouring output words, so the
// stores coalesce, and the thousands of warps in flight take the role of the
// TPU kernel's DMA ring and semaphores. A thread loads its id, range-checks
// it (and the mask), and only then reads the table: out-of-range rows are
// never loaded. All index math is 64-bit, so tables of more than 2^31
// elements and int64 ids past 2^31 are safe.
//
// The copy is bitwise: elements are moved as raw 16- or 32-bit words, so
// bfloat16 rows take no float arithmetic and NaN payloads or -0.0 survive.
//
// Plain C interface (bound from Python with ctypes in `ops/gather.py`): the
// function launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() so the wrapper can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;  // 64 blocks per SM on an H100

template <typename Word, typename Id>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Word* __restrict__ w, int64_t n_rows, int64_t dim,
                   const Id* __restrict__ rows,
                   const uint8_t* __restrict__ valid, int64_t n,
                   Word* __restrict__ out) {
  const int64_t total = n * dim;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t i = e / dim;
    const int64_t c = e - i * dim;
    const int64_t r = static_cast<int64_t>(rows[i]);
    const bool ok = r >= 0 && r < n_rows && (valid == nullptr || valid[i]);
    out[e] = ok ? w[r * dim + c] : Word(0);
  }
}

template <typename Word>
void launch(const void* w, int64_t n_rows, int64_t dim, const void* rows,
            int id_bytes, const void* valid, int64_t n, void* out,
            cudaStream_t stream) {
  const int64_t total = n * dim;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks));
  const auto* vw = static_cast<const Word*>(w);
  const auto* vm = static_cast<const uint8_t*>(valid);
  auto* vo = static_cast<Word*>(out);
  if (id_bytes == 8) {
    gather_rows_kernel<Word, int64_t><<<grid, kThreads, 0, stream>>>(
        vw, n_rows, dim, static_cast<const int64_t*>(rows), vm, n, vo);
  } else {
    gather_rows_kernel<Word, int32_t><<<grid, kThreads, 0, stream>>>(
        vw, n_rows, dim, static_cast<const int32_t*>(rows), vm, n, vo);
  }
}

}  // namespace

extern "C" {

// elem_bytes: 4 (float32) or 2 (bfloat16); id_bytes: 4 (int32) or 8 (int64);
// valid: a uint8/bool mask of n entries, or NULL. Returns a cudaError_t.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    launch<uint32_t>(w, n_rows, dim, rows, id_bytes, valid, n, out, s);
  } else {
    launch<uint16_t>(w, n_rows, dim, rows, id_bytes, valid, n, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* oe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
