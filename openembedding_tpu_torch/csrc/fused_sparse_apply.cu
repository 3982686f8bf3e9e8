// Fused sparse optimizer apply for embedding tables: for every slot i with
// counts[i] > 0 and 0 <= rows[i] < n_rows, read the weight row and every
// optimizer slot row of rows[i], run the optimizer's row update in float32,
// and write both back in place. No other row is read or written. Rows with
// counts > 0 are unique (the caller dedups first), so no two slots write one
// row.
//
// Replaces the TPU kernel `openembedding_tpu/ops/pallas_sparse.py::
// fused_sparse_apply` (`_apply_call` / `_apply_kernel`). That kernel stages
// blocks of 256 rows in VMEM with one DMA per (row, array) through a ring of
// 8 DMA semaphores, loads from clamped indices, updates the whole block on
// the vector unit, and stores back under a count > 0 predicate
// (`input_output_aliases` makes the update in place).
//
// What bounds it on an H100: memory. Per touched row the Adagrad update reads
// the weight, accumulator and gradient rows and writes the weight and
// accumulator rows (200 bytes at the flagship width of 10 float32 columns),
// for about 12 floating-point operations per element. The table rows are
// short and randomly placed, so each row access touches one or two 32-byte
// sectors and the work is latency-bound unless many rows are in flight.
//
// What the design does about it: a group of L threads (L = the row width
// rounded up to a power of two, at most 32) owns one slot i; the groups of a
// warp own neighbouring slots, and a grid-stride loop walks the slots. The
// thousands of warps in flight take the role of the TPU kernel's DMA ring.
// A thread reads the count, then the row id, range-checks it, and only then
// touches the table: rows with a count of 0 are never loaded. Per-row state
// one column wide (Adam's and Adamax's beta powers, TestOptimizer's flip
// state) is read by every thread of the group before a `__syncwarp()`, and
// written once, by the group's first thread, after it: no thread can read a
// value another has already replaced.
//
// Rounding matches the plain PyTorch rules (`optimizers.py`) bit for bit:
// every operation is written as a correctly rounded intrinsic (`__fmul_rn`,
// `__fadd_rn`, `__fsub_rn`, `__fdiv_rn`, `__fsqrt_rn`), which nvcc never
// contracts into a fused multiply-add, in the operation order of the JAX
// rule. The hyperparameters arrive folded on the host in double and rounded
// to float, as the plain rules use them. Ftrl with learning_rate_power
// != -0.5 uses `powf`, which is not correctly rounded: there the kernel and
// the plain version may differ by an ulp. A bfloat16 table is upcast and
// rounded back to nearest even (`__float2bfloat16_rn`).
//
// Arrays are passed as a base pointer and a row stride in elements, so a
// later packed layout (weights and slots as column ranges of one array)
// runs through the same kernel.
//
// Plain C interface (bound with ctypes in `ops/apply.py`): the function
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError() so the wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;  // 64 blocks per SM on an H100
constexpr int kMaxSlots = 4;
constexpr int kMaxHyper = 8;

// Rule numbers (`SparseOptimizer.rule`) and, per rule, the slots in
// `slot_shapes` order and the constants in `hyper()` order.
enum Rule {
  kDefault = 0,   // hyper: lr
  kSGD = 1,       // slots: moment; hyper: lr, momentum, nesterov (0 or 1)
  kAdagrad = 2,   // slots: accum; hyper: lr, eps
  kAdadelta = 3,  // slots: accum, accum_update; hyper: lr, rho, 1-rho, eps
  kAdam = 4,      // slots: m, v, beta_1_t (1 wide), beta_2_t (1 wide);
                  // hyper: lr, b1, b2, 1-b1, 1-b2, eps
  kAdamax = 5,    // slots: m, v, beta_1_t (1 wide); hyper: lr, b1, b2, 1-b1,
                  // eps
  kFtrl = 6,      // slots: accum, linear; hyper: lr, l1, 2*adjusted_l2,
                  // 2*l2_shrinkage, -lr_power, lr_power == -0.5 (0 or 1)
  kRMSprop = 7,   // slots: accum, moment; hyper: lr, rho, momentum, 1-rho,
                  // eps
  kTest = 8,      // slots: flip_state (1 wide); hyper: lr, flip
  kNumRules = 9
};
__host__ __device__ constexpr int rule_slots(int r) {
  return r == kDefault ? 0
       : r == kAdam ? 4
       : r == kAdamax ? 3
       : (r == kSGD || r == kAdagrad || r == kTest) ? 1
       : 2;
}
constexpr int kRuleHyper[kNumRules] = {1, 3, 2, 4, 6, 5, 6, 5, 2};

struct Params {
  float h[kMaxHyper];
  void* w;
  int64_t w_stride;
  float* s[kMaxSlots];
  int64_t s_stride[kMaxSlots];
  const void* rows;
  const float* g;
  int64_t g_stride;
  const int32_t* counts;
  int64_t n;
  int64_t n_rows;
  int64_t dim;
  int lanes_log2;  // log2 of the threads that share one slot
};

__device__ __forceinline__ float load_w(const float* p) { return *p; }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_w(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_w(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

template <int R, typename T, typename Id>
__global__ void __launch_bounds__(kThreads) fused_apply_kernel(Params p) {
  const int lanes = 1 << p.lanes_log2;
  const int lane = threadIdx.x & 31;
  const int col0 = lane & (lanes - 1);
  const int64_t rows_per_warp = 32 >> p.lanes_log2;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const float* h = p.h;
  // `base` is the same for every lane of a warp, so every lane runs the same
  // iterations and reaches each __syncwarp()
  for (int64_t base = warp * rows_per_warp; base < p.n;
       base += n_warps * rows_per_warp) {
    const int64_t i = base + (lane >> p.lanes_log2);
    int32_t count = 0;
    int64_t r = -1;
    if (i < p.n) {
      count = p.counts[i];
      if (count > 0) r = static_cast<int64_t>(static_cast<const Id*>(p.rows)[i]);
    }
    const bool live = count > 0 && r >= 0 && r < p.n_rows;

    // per-row state, read by every lane before any lane writes it
    float row_a = 0.f, row_b = 0.f;
    if (live) {
      if constexpr (R == kAdam) {
        row_a = p.s[2][r * p.s_stride[2]];
        row_b = p.s[3][r * p.s_stride[3]];
      } else if constexpr (R == kAdamax) {
        row_a = p.s[2][r * p.s_stride[2]];
      } else if constexpr (R == kTest) {
        row_a = p.s[0][r * p.s_stride[0]];
      }
    }
    __syncwarp();
    if (!live) continue;

    // the row's new per-row state and the factors every column shares
    float row_lr = 0.f;
    if constexpr (R == kAdam) {
      row_a = mul(row_a, h[1]);  // beta_1_t * beta_1
      row_b = mul(row_b, h[2]);  // beta_2_t * beta_2
      row_lr = div(mul(h[0], sqrt_rn(sub(1.f, row_b))), sub(1.f, row_a));
    } else if constexpr (R == kAdamax) {
      row_a = mul(row_a, h[1]);
      row_lr = div(h[0], sub(1.f, row_a));
    } else if constexpr (R == kTest) {
      row_a = sub(h[1], row_a);  // flip - flip_state
      row_lr = static_cast<float>(count);  // count >= 1 here
    }

    T* w_row = static_cast<T*>(p.w) + r * p.w_stride;
    const float* g_row = p.g + i * p.g_stride;
    float* s0 = rule_slots(R) > 0 ? p.s[0] + r * p.s_stride[0] : nullptr;
    float* s1 = rule_slots(R) > 1 ? p.s[1] + r * p.s_stride[1] : nullptr;
    for (int64_t c = col0; c < p.dim; c += lanes) {
      const float g = g_row[c];
      float w = load_w(w_row + c);
      if constexpr (R == kDefault) {
        w = sub(w, mul(h[0], g));
      } else if constexpr (R == kSGD) {
        const float m = add(mul(s0[c], h[1]), mul(h[0], g));
        s0[c] = m;
        w = h[2] != 0.f ? sub(w, add(mul(m, h[1]), mul(h[0], g)))
                        : sub(w, m);
      } else if constexpr (R == kAdagrad) {
        const float a = add(s0[c], mul(g, g));
        s0[c] = a;
        w = sub(w, div(mul(h[0], g), add(sqrt_rn(a), h[1])));
      } else if constexpr (R == kAdadelta) {
        const float a = add(mul(s0[c], h[1]), mul(mul(g, g), h[2]));
        const float au = s1[c];
        const float upd =
            div(mul(g, sqrt_rn(add(au, h[3]))), sqrt_rn(add(a, h[3])));
        s0[c] = a;
        s1[c] = add(mul(au, h[1]), mul(mul(upd, upd), h[2]));
        w = sub(w, mul(h[0], upd));
      } else if constexpr (R == kAdam) {
        const float m = add(mul(s0[c], h[1]), mul(g, h[3]));
        const float v = add(mul(s1[c], h[2]), mul(mul(g, g), h[4]));
        s0[c] = m;
        s1[c] = v;
        w = sub(w, div(mul(row_lr, m), add(sqrt_rn(v), h[5])));
      } else if constexpr (R == kAdamax) {
        const float m = add(mul(s0[c], h[1]), mul(g, h[3]));
        const float v = fmaxf(fabsf(g), mul(s1[c], h[2]));
        s0[c] = m;
        s1[c] = v;
        w = sub(w, div(mul(row_lr, m), add(v, h[4])));
      } else if constexpr (R == kFtrl) {
        const float a = s0[c];
        const float a_new = add(a, mul(g, g));
        const float g_adj = add(g, mul(h[3], w));
        float sigma, quadratic;
        if (h[5] != 0.f) {
          const float root_new = sqrt_rn(a_new);
          sigma = div(sub(root_new, sqrt_rn(a)), h[0]);
          quadratic = add(div(root_new, h[0]), h[2]);
        } else {
          const float pow_new = powf(a_new, h[4]);
          sigma = div(sub(pow_new, powf(a, h[4])), h[0]);
          quadratic = add(div(pow_new, h[0]), h[2]);
        }
        const float lin_new = sub(add(s1[c], g_adj), mul(sigma, w));
        const float l1_adjust = fminf(fmaxf(lin_new, -h[1]), h[1]);
        s0[c] = a_new;
        s1[c] = lin_new;
        w = div(sub(l1_adjust, lin_new), quadratic);
      } else if constexpr (R == kRMSprop) {
        const float a = add(mul(s0[c], h[1]), mul(mul(g, g), h[3]));
        const float mo =
            add(mul(s1[c], h[2]), div(mul(h[0], g), sqrt_rn(add(a, h[4]))));
        s0[c] = a;
        s1[c] = mo;
        w = sub(w, mo);
      } else if constexpr (R == kTest) {
        w = add(add(w, div(mul(h[0], g), row_lr)), row_a);
      }
      store_w(w_row + c, w);
    }
    if (col0 == 0) {
      if constexpr (R == kAdam) {
        p.s[2][r * p.s_stride[2]] = row_a;
        p.s[3][r * p.s_stride[3]] = row_b;
      } else if constexpr (R == kAdamax) {
        p.s[2][r * p.s_stride[2]] = row_a;
      } else if constexpr (R == kTest) {
        p.s[0][r * p.s_stride[0]] = row_a;
      }
    }
  }
}

template <int R, typename T>
void launch_ids(const Params& p, int id_bytes, dim3 grid, cudaStream_t s) {
  if (id_bytes == 8) {
    fused_apply_kernel<R, T, int64_t><<<grid, kThreads, 0, s>>>(p);
  } else {
    fused_apply_kernel<R, T, int32_t><<<grid, kThreads, 0, s>>>(p);
  }
}

template <int R>
void launch_rule(const Params& p, int elem_bytes, int id_bytes, dim3 grid,
                 cudaStream_t s) {
  if (elem_bytes == 4) {
    launch_ids<R, float>(p, id_bytes, grid, s);
  } else {
    launch_ids<R, __nv_bfloat16>(p, id_bytes, grid, s);
  }
}

}  // namespace

extern "C" {

// rule: a `Rule`; hyper: n_hyper floats in the rule's order; w: the table
// (elem_bytes 4 = float32, 2 = bfloat16), row stride w_stride elements;
// slots: n_slots float32 arrays in the rule's order, row strides
// slot_strides; rows: n ids (id_bytes 4 or 8); grads: n float32 rows of dim,
// row stride g_stride; counts: n int32. Returns a cudaError_t.
int oe_fused_sparse_apply(int rule, const float* hyper, int n_hyper, void* w,
                          int64_t w_stride, int elem_bytes, int64_t n_rows,
                          int64_t dim, int n_slots, void* const* slots,
                          const int64_t* slot_strides, const void* rows,
                          int id_bytes, const float* grads, int64_t g_stride,
                          const int32_t* counts, int64_t n, void* stream) {
  if (rule < 0 || rule >= kNumRules || n_slots != rule_slots(rule) ||
      n_hyper != kRuleHyper[rule] || (elem_bytes != 2 && elem_bytes != 4) ||
      (id_bytes != 4 && id_bytes != 8) || n < 0 || dim < 0 || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n * dim == 0) {
    return static_cast<int>(cudaSuccess);
  }
  Params p = {};
  for (int k = 0; k < n_hyper; ++k) p.h[k] = hyper[k];
  p.w = w;
  p.w_stride = w_stride;
  for (int k = 0; k < n_slots; ++k) {
    p.s[k] = static_cast<float*>(slots[k]);
    p.s_stride[k] = slot_strides[k];
  }
  p.rows = rows;
  p.g = grads;
  p.g_stride = g_stride;
  p.counts = counts;
  p.n = n;
  p.n_rows = n_rows;
  p.dim = dim;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < dim && lanes_log2 < 5) ++lanes_log2;
  p.lanes_log2 = lanes_log2;

  const int64_t rows_per_block = (kThreads / 32) * (32 >> lanes_log2);
  int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case kDefault: launch_rule<kDefault>(p, elem_bytes, id_bytes, grid, s); break;
    case kSGD: launch_rule<kSGD>(p, elem_bytes, id_bytes, grid, s); break;
    case kAdagrad: launch_rule<kAdagrad>(p, elem_bytes, id_bytes, grid, s); break;
    case kAdadelta: launch_rule<kAdadelta>(p, elem_bytes, id_bytes, grid, s); break;
    case kAdam: launch_rule<kAdam>(p, elem_bytes, id_bytes, grid, s); break;
    case kAdamax: launch_rule<kAdamax>(p, elem_bytes, id_bytes, grid, s); break;
    case kFtrl: launch_rule<kFtrl>(p, elem_bytes, id_bytes, grid, s); break;
    case kRMSprop: launch_rule<kRMSprop>(p, elem_bytes, id_bytes, grid, s); break;
    case kTest: launch_rule<kTest>(p, elem_bytes, id_bytes, grid, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* oe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
