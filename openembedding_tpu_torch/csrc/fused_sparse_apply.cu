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
// sectors, and the time is that of the dependent chain count/id load ->
// row loads -> stores unless many row loads are in flight at once.
//
// What the design does about it (the lane map of the row-copy core,
// `gather_core.cuh`):
// - A warp owns a tile of up to 32 slots. Lane i loads slot i's count and
//   id together, in one coalesced round, range-checks the id once and turns
//   it into the row's first word in each table array (the one 64-bit
//   product per row). A ballot of the live lanes ends a tile with no live
//   slot after that round, so the dedup's padding tail costs one coalesced
//   load per 32 slots.
// - The tile's words (E elements each: 4, 2 or 1, the most that divides the
//   width and every wide array's address and row stride; `plan`) are
//   numbered row-major and word e goes to lane e % 32: every lane works. A
//   lane walks its words with the core's cursor (no division per element,
//   32-bit index math inside a tile) and gets each row's keys from the
//   row's lane by `__shfl_sync`. Gradient rows are addressed by slot.
// - Each lane issues the loads of all its words of the tile (up to U a
//   round, of the gradient, the weights and every dim-wide slot) before it
//   computes or stores any of them: the TPU kernel's ring of DMAs. U is set
//   per rule and word so that a lane holds about 30 floats of loaded words.
//   The stores walk the round's words again and remake each address from
//   the row's keys, so no address is held while the loads are in flight
//   (fewer registers and spills: PERF.md).
// - Per-row state one column wide (Adam's and Adamax's beta powers,
//   TestOptimizer's flip state, and its count) is read, updated and written
//   by the row's own lane, which passes the row's factors to the word lanes
//   by `__shfl_sync`: no other lane touches the value.
// - The grid is what the card holds at once: SMs x resident blocks per SM
//   of each instance, read once per card when the library loads
//   (`oe_fused_sparse_apply_init`); each warp loops over tiles. Nothing is
//   queried per launch, so a launch can be captured into a CUDA graph.
// - Stores stream (`st.global.cs`), as the row-copy core's do: on the H100
//   they measured faster than write-back, also when the next batch's pull
//   reads the written rows after the update (PERF.md).
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
// Arrays are passed as a base pointer and a row stride in elements, so the
// packed layout (weights and slots as column ranges of one array) runs
// through the same kernel.
//
// Plain C interface (bound with ctypes in `ops/apply.py`): the function
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError() so the wrapper can raise.

#include <cuda_bf16.h>

#include "gather_core.cuh"

namespace {

using oe_gather::Cursor;
using oe_gather::RowMap;
using oe_gather::kFull;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 4;
constexpr int kMaxHyper = 8;
constexpr int kMaxDevices = 64;
constexpr int kWordFloats = 30;  // floats of loaded words a lane holds
constexpr int kMaxUnroll = 8;
constexpr int kMaxGradWords = 1 << 26;  // so 32 gradient rows stay 32-bit

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
// the slots as wide as the row, first in every rule's order; the rest are
// one column of per-row state
__host__ __device__ constexpr int wide_slots(int r) {
  return (r == kDefault || r == kTest) ? 0
       : (r == kSGD || r == kAdagrad) ? 1
       : 2;
}
constexpr int kRuleHyper[kNumRules] = {1, 3, 2, 4, 6, 5, 6, 5, 2};

// Words a lane loads of each array in one round: about kWordFloats floats
// of the gradient, the weights and the wide slots, at least 1.
__host__ __device__ constexpr int unroll(int r, int e) {
  const int u = kWordFloats / ((2 + wide_slots(r)) * e);
  return u < 1 ? 1 : (u > kMaxUnroll ? kMaxUnroll : u);
}

// A word of E elements of T, moved as one access.
template <int Bytes> struct RawOf;
template <> struct RawOf<2> { using type = unsigned short; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };
template <typename T, int E>
using Raw = typename RawOf<static_cast<int>(sizeof(T)) * E>::type;

// Element bits <-> float: a bfloat16 is the high half of a float32.
template <typename T>
__device__ __forceinline__ float to_f(unsigned int bits) {
  return __uint_as_float(sizeof(T) == 4 ? bits : bits << 16);
}
template <typename T>
__device__ __forceinline__ unsigned int from_f(float v) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(v);
  } else {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
}

template <typename T, int E>
__device__ __forceinline__ void unpack(const Raw<T, E>& r, float (&f)[E]) {
  if constexpr (sizeof(T) == 4 && E == 1) {
    f[0] = to_f<T>(r);
  } else if constexpr (sizeof(T) == 4 && E == 2) {
    f[0] = to_f<T>(r.x);
    f[1] = to_f<T>(r.y);
  } else if constexpr (sizeof(T) == 4) {
    f[0] = to_f<T>(r.x);
    f[1] = to_f<T>(r.y);
    f[2] = to_f<T>(r.z);
    f[3] = to_f<T>(r.w);
  } else if constexpr (E == 1) {
    f[0] = to_f<T>(r);
  } else if constexpr (E == 2) {
    f[0] = to_f<T>(r & 0xffffu);
    f[1] = to_f<T>(r >> 16);
  } else {
    f[0] = to_f<T>(r.x & 0xffffu);
    f[1] = to_f<T>(r.x >> 16);
    f[2] = to_f<T>(r.y & 0xffffu);
    f[3] = to_f<T>(r.y >> 16);
  }
}

template <typename T, int E>
__device__ __forceinline__ Raw<T, E> pack(const float (&f)[E]) {
  Raw<T, E> r;
  if constexpr (sizeof(T) == 4 && E == 1) {
    r = from_f<T>(f[0]);
  } else if constexpr (sizeof(T) == 4 && E == 2) {
    r.x = from_f<T>(f[0]);
    r.y = from_f<T>(f[1]);
  } else if constexpr (sizeof(T) == 4) {
    r.x = from_f<T>(f[0]);
    r.y = from_f<T>(f[1]);
    r.z = from_f<T>(f[2]);
    r.w = from_f<T>(f[3]);
  } else if constexpr (E == 1) {
    r = static_cast<unsigned short>(from_f<T>(f[0]));
  } else if constexpr (E == 2) {
    r = from_f<T>(f[0]) | (from_f<T>(f[1]) << 16);
  } else {
    r.x = from_f<T>(f[0]) | (from_f<T>(f[1]) << 16);
    r.y = from_f<T>(f[2]) | (from_f<T>(f[3]) << 16);
  }
  return r;
}

struct Params {
  float h[kMaxHyper];
  void* w;                    // E-element words
  int64_t w_stride;           // words
  float* s[kMaxSlots];        // wide slots: E-element words; the rest: floats
  int64_t s_stride[kMaxSlots];  // wide slots: words; the rest: floats
  const void* rows;
  int ids64;                  // rows are int64 (else int32)
  const float* g;             // E-element words
  int g_stride;               // words
  const int32_t* counts;
  int64_t n;
  int64_t n_rows;
  RowMap m;                   // rw = words a row
  int tile;                   // slots a tile
  int64_t tiles;
};

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

// One element of a row: weight w, wide slots s0 and s1, gradient g; row_lr
// and row_a are the row's factors from its per-row state.
template <int R>
__device__ __forceinline__ void update(const float* h, float g, float& w,
                                       float& s0, float& s1, float row_lr,
                                       float row_a) {
  if constexpr (R == kDefault) {
    w = sub(w, mul(h[0], g));
  } else if constexpr (R == kSGD) {
    const float m = add(mul(s0, h[1]), mul(h[0], g));
    s0 = m;
    w = h[2] != 0.f ? sub(w, add(mul(m, h[1]), mul(h[0], g))) : sub(w, m);
  } else if constexpr (R == kAdagrad) {
    const float a = add(s0, mul(g, g));
    s0 = a;
    w = sub(w, div(mul(h[0], g), add(sqrt_rn(a), h[1])));
  } else if constexpr (R == kAdadelta) {
    const float a = add(mul(s0, h[1]), mul(mul(g, g), h[2]));
    const float au = s1;
    const float upd =
        div(mul(g, sqrt_rn(add(au, h[3]))), sqrt_rn(add(a, h[3])));
    s0 = a;
    s1 = add(mul(au, h[1]), mul(mul(upd, upd), h[2]));
    w = sub(w, mul(h[0], upd));
  } else if constexpr (R == kAdam) {
    const float m = add(mul(s0, h[1]), mul(g, h[3]));
    const float v = add(mul(s1, h[2]), mul(mul(g, g), h[4]));
    s0 = m;
    s1 = v;
    w = sub(w, div(mul(row_lr, m), add(sqrt_rn(v), h[5])));
  } else if constexpr (R == kAdamax) {
    const float m = add(mul(s0, h[1]), mul(g, h[3]));
    const float v = fmaxf(fabsf(g), mul(s1, h[2]));
    s0 = m;
    s1 = v;
    w = sub(w, div(mul(row_lr, m), add(v, h[4])));
  } else if constexpr (R == kFtrl) {
    const float a = s0;
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
    const float lin_new = sub(add(s1, g_adj), mul(sigma, w));
    const float l1_adjust = fminf(fmaxf(lin_new, -h[1]), h[1]);
    s0 = a_new;
    s1 = lin_new;
    w = div(sub(l1_adjust, lin_new), quadratic);
  } else if constexpr (R == kRMSprop) {
    const float a = add(mul(s0, h[1]), mul(mul(g, g), h[3]));
    const float mo =
        add(mul(s1, h[2]), div(mul(h[0], g), sqrt_rn(add(a, h[4]))));
    s0 = a;
    s1 = mo;
    w = sub(w, mo);
  } else if constexpr (R == kTest) {
    w = add(add(w, div(mul(h[0], g), row_lr)), row_a);
  }
}

template <int R, typename T, int E>
__global__ void __launch_bounds__(kThreads)
fused_apply_kernel(const Params p) {
  constexpr int U = unroll(R, E);
  constexpr int W = wide_slots(R);
  constexpr int WS = W > 0 ? W : 1;  // array extents (unused when W == 0)
  constexpr bool kRowState = R == kAdam || R == kAdamax || R == kTest;
  using TW = Raw<T, E>;
  using FW = Raw<float, E>;
  const int lane = threadIdx.x & 31;
  const Cursor start = oe_gather::first_word(p.m);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  TW* const w_words = static_cast<TW*>(p.w);
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       t < p.tiles; t += stride) {
    const int64_t slot0 = t * p.tile;
    const int64_t left = p.n - slot0;
    const int here = left < p.tile ? static_cast<int>(left) : p.tile;

    // one coalesced round: this lane's slot's count and id, loaded together
    int32_t count = 0;
    int64_t r = -1;
    if (lane < here) {
      count = __ldg(p.counts + slot0 + lane);
      r = p.ids64 ? __ldg(static_cast<const long long*>(p.rows) + slot0 +
                          lane)
                  : __ldg(static_cast<const int32_t*>(p.rows) + slot0 +
                          lane);
    }
    const bool live = count > 0 && r >= 0 && r < p.n_rows;
    if (__ballot_sync(kFull, live) == 0) continue;  // the same in every lane

    // the row's first word in each table array; -1: no row to touch
    long long key_w = -1;
    long long key_s[WS];
#pragma unroll
    for (int k = 0; k < WS; ++k) key_s[k] = -1;
    // this lane's row's per-row state, loaded beside the row words below
    float st_a = 0.f, st_b = 0.f;
    if (live) {
      key_w = r * p.w_stride;
#pragma unroll
      for (int k = 0; k < W; ++k) key_s[k] = r * p.s_stride[k];
      if constexpr (R == kAdam) {
        st_a = p.s[2][r * p.s_stride[2]];
        st_b = p.s[3][r * p.s_stride[3]];
      } else if constexpr (R == kAdamax) {
        st_a = p.s[2][r * p.s_stride[2]];
      } else if constexpr (R == kTest) {
        st_a = p.s[0][r * p.s_stride[0]];
      }
    }
    float row_lr = 0.f, row_a = 0.f;

    const FW* g_words = reinterpret_cast<const FW*>(p.g) + slot0 * p.g_stride;
    Cursor c = start;
    const int total = here * p.m.rw;
    for (int e0 = 0; e0 < total; e0 += 32 * U) {
      // all of this round's loads
      const Cursor round_start = c;
      FW gv[U];
      TW wv[U];
      FW sv[WS][U];
      unsigned go = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = c.row & 31;
        const long long kw = __shfl_sync(kFull, key_w, src);
        long long ks[WS];
#pragma unroll
        for (int k = 0; k < W; ++k) ks[k] = __shfl_sync(kFull, key_s[k], src);
        if (e0 + u * 32 + lane < total && kw >= 0) {
          go |= 1u << u;
          gv[u] = __ldg(g_words + c.row * p.g_stride + c.word);
          wv[u] = w_words[kw + c.word];
#pragma unroll
          for (int k = 0; k < W; ++k) {
            sv[k][u] = reinterpret_cast<const FW*>(p.s[k])[ks[k] + c.word];
          }
        }
        oe_gather::advance(c, p.m);
      }

      // the row's lane turns its per-row state into the row's factors and
      // writes the new state, once per tile
      if (kRowState && e0 == 0) {
        if constexpr (R == kAdam) {
          st_a = mul(st_a, p.h[1]);  // beta_1_t * beta_1
          st_b = mul(st_b, p.h[2]);  // beta_2_t * beta_2
          row_lr = div(mul(p.h[0], sqrt_rn(sub(1.f, st_b))), sub(1.f, st_a));
          if (live) {
            __stcs(p.s[2] + r * p.s_stride[2], st_a);
            __stcs(p.s[3] + r * p.s_stride[3], st_b);
          }
        } else if constexpr (R == kAdamax) {
          st_a = mul(st_a, p.h[1]);
          row_lr = div(p.h[0], sub(1.f, st_a));
          if (live) __stcs(p.s[2] + r * p.s_stride[2], st_a);
        } else if constexpr (R == kTest) {
          row_a = sub(p.h[1], st_a);            // flip - flip_state
          row_lr = static_cast<float>(count);  // count >= 1 where live
          if (live) __stcs(p.s[0] + r * p.s_stride[0], row_a);
        }
      }

      // the rule on the loaded words, then the stores, each to an address
      // made again from the row's keys (the round's cursor walked a second
      // time), so that no address is held while the loads are in flight
      c = round_start;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = c.row & 31;
        const int word = c.word;
        oe_gather::advance(c, p.m);
        const long long kw = __shfl_sync(kFull, key_w, src);
        long long ks[WS];
#pragma unroll
        for (int k = 0; k < W; ++k) ks[k] = __shfl_sync(kFull, key_s[k], src);
        float lr = 0.f, ra = 0.f;
        if constexpr (kRowState) lr = __shfl_sync(kFull, row_lr, src);
        if constexpr (R == kTest) ra = __shfl_sync(kFull, row_a, src);
        if (!(go & (1u << u))) continue;
        float gf[E], wf[E], s0[E], s1[E];
        unpack<float, E>(gv[u], gf);
        unpack<T, E>(wv[u], wf);
        if constexpr (W > 0) unpack<float, E>(sv[0][u], s0);
        if constexpr (W > 1) unpack<float, E>(sv[W - 1][u], s1);
#pragma unroll
        for (int j = 0; j < E; ++j) {
          update<R>(p.h, gf[j], wf[j], s0[j], s1[j], lr, ra);
        }
        __stcs(w_words + kw + word, pack<T, E>(wf));
        if constexpr (W > 0) {
          __stcs(reinterpret_cast<FW*>(p.s[0]) + ks[0] + word,
                 pack<float, E>(s0));
        }
        if constexpr (W > 1) {
          __stcs(reinterpret_cast<FW*>(p.s[W - 1]) + ks[W - 1] + word,
                 pack<float, E>(s1));
        }
      }
    }
  }
}

// One kernel instance: a rule, a table type and a word of E elements.
template <int R_, typename T_, int E_>
struct Instance {
  static constexpr int R = R_;
  using T = T_;
  static constexpr int E = E_;
};

constexpr int kWordElems[] = {4, 2, 1};
constexpr int kInstances = kNumRules * 2 * 3;

constexpr int instance_index(int rule, bool bf16, int e) {
  return (rule * 2 + (bf16 ? 1 : 0)) * 3 + (e == 4 ? 0 : e == 2 ? 1 : 2);
}

// resident blocks of each instance on each device; 0 until initialised
int g_blocks[kMaxDevices][kInstances];

template <int R, typename T, typename F>
cudaError_t with_word(int e, F& f) {
  switch (e) {
    case 4: return f(Instance<R, T, 4>{});
    case 2: return f(Instance<R, T, 2>{});
    default: return f(Instance<R, T, 1>{});
  }
}

template <int R, typename F>
cudaError_t with_table(bool bf16, int e, F& f) {
  return bf16 ? with_word<R, __nv_bfloat16>(e, f) : with_word<R, float>(e, f);
}

// Calls f(Instance<rule, T, e>{}) for the runtime (rule, bf16, e).
template <typename F>
cudaError_t with_instance(int rule, bool bf16, int e, F&& f) {
  switch (rule) {
    case kDefault: return with_table<kDefault>(bf16, e, f);
    case kSGD: return with_table<kSGD>(bf16, e, f);
    case kAdagrad: return with_table<kAdagrad>(bf16, e, f);
    case kAdadelta: return with_table<kAdadelta>(bf16, e, f);
    case kAdam: return with_table<kAdam>(bf16, e, f);
    case kAdamax: return with_table<kAdamax>(bf16, e, f);
    case kFtrl: return with_table<kFtrl>(bf16, e, f);
    case kRMSprop: return with_table<kRMSprop>(bf16, e, f);
    case kTest: return with_table<kTest>(bf16, e, f);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

struct Plan {
  int e;     // elements a word
  int tile;  // slots a tile
};

// The word (E = 4, 2 or 1 elements) and the tile of one launch: E divides
// the width and, in bytes, the address and row stride of the weights, of
// each wide slot and of the gradients.
Plan plan(int rule, int64_t dim, const void* w, int64_t w_stride,
          int elem_bytes, void* const* slots, const int64_t* slot_strides,
          const void* g, int64_t g_stride) {
  int e = 1;
  for (int cand : kWordElems) {
    bool ok = dim % cand == 0 && w_stride % cand == 0 &&
              aligned(w, cand * elem_bytes) && g_stride % cand == 0 &&
              aligned(g, cand * 4);
    for (int k = 0; k < wide_slots(rule); ++k) {
      ok = ok && slot_strides[k] % cand == 0 && aligned(slots[k], cand * 4);
    }
    if (ok) {
      e = cand;
      break;
    }
  }
  const int rw = static_cast<int>(dim / e);
  return Plan{e, oe_gather::tile_rows(rw, unroll(rule, e))};
}

bool valid_args(int rule, int n_hyper, int elem_bytes, int id_bytes,
                int n_slots, int64_t n, int64_t dim, int64_t n_rows) {
  return rule >= 0 && rule < kNumRules && n_slots == rule_slots(rule) &&
         n_hyper == kRuleHyper[rule] && (elem_bytes == 2 || elem_bytes == 4)
         && (id_bytes == 4 || id_bytes == 8) && n >= 0 && dim >= 0 &&
         n_rows >= 0;
}

int current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*dev < 0 || *dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" {

// Reads the current device's SM count and each instance's resident blocks
// per SM. Call once per device, before the first launch on it and never
// inside a graph capture. Returns a cudaError_t.
int oe_fused_sparse_apply_init() {
  int dev = 0;
  const int rc = current_device(&dev);
  if (rc != 0) return rc;
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int rule = 0; rule < kNumRules; ++rule) {
    for (int bf16 = 0; bf16 < 2; ++bf16) {
      for (int e : kWordElems) {
        err = with_instance(rule, bf16, e, [&](auto inst) {
          using I = decltype(inst);
          int per_sm = 0;
          const cudaError_t got =
              cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, fused_apply_kernel<I::R, typename I::T, I::E>,
                  kThreads, 0);
          g_blocks[dev][instance_index(rule, bf16, e)] =
              sms * (per_sm > 0 ? per_sm : 1);
          return got;
        });
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
  }
  return static_cast<int>(cudaSuccess);
}

// The most blocks a launch takes on the current device for this rule,
// table element size and word; 0 before oe_fused_sparse_apply_init.
int oe_fused_sparse_apply_resident_blocks(int rule, int elem_bytes,
                                          int word_elems) {
  int dev = 0;
  if (current_device(&dev) != 0 || rule < 0 || rule >= kNumRules) return 0;
  return g_blocks[dev][instance_index(rule, elem_bytes == 2, word_elems)];
}

// The launch's word (elements) and tile (slots) for these arrays, as
// `oe_fused_sparse_apply` picks them; `ops/apply.launch_plan` mirrors it.
// Returns a cudaError_t.
int oe_fused_sparse_apply_plan(int rule, int64_t dim, const void* w,
                               int64_t w_stride, int elem_bytes,
                               void* const* slots,
                               const int64_t* slot_strides,
                               const float* grads, int64_t g_stride,
                               int* word_elems, int* tile_rows) {
  if (rule < 0 || rule >= kNumRules || dim <= 0 ||
      (elem_bytes != 2 && elem_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = plan(rule, dim, w, w_stride, elem_bytes, slots,
                       slot_strides, grads, g_stride);
  *word_elems = pl.e;
  *tile_rows = pl.tile;
  return static_cast<int>(cudaSuccess);
}

// rule: a `Rule`; hyper: n_hyper floats in the rule's order; w: the table
// (elem_bytes 4 = float32, 2 = bfloat16), row stride w_stride elements;
// slots: n_slots float32 arrays in the rule's order, row strides
// slot_strides; rows: n ids (id_bytes 4 or 8); grads: n float32 rows of dim,
// row stride g_stride; counts: n int32. Launches on the current device,
// which oe_fused_sparse_apply_init has seen; stores stream. Returns a
// cudaError_t.
int oe_fused_sparse_apply(int rule, const float* hyper, int n_hyper, void* w,
                          int64_t w_stride, int elem_bytes, int64_t n_rows,
                          int64_t dim, int n_slots, void* const* slots,
                          const int64_t* slot_strides, const void* rows,
                          int id_bytes, const float* grads, int64_t g_stride,
                          const int32_t* counts, int64_t n, void* stream) {
  if (!valid_args(rule, n_hyper, elem_bytes, id_bytes, n_slots, n, dim,
                  n_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n * dim == 0) {
    return static_cast<int>(cudaSuccess);
  }
  int dev = 0;
  const int rc = current_device(&dev);
  if (rc != 0) return rc;
  const Plan pl = plan(rule, dim, w, w_stride, elem_bytes, slots,
                       slot_strides, grads, g_stride);
  if (g_stride / pl.e >= kMaxGradWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = elem_bytes == 2;
  const int resident = g_blocks[dev][instance_index(rule, bf16, pl.e)];
  if (resident <= 0) return static_cast<int>(cudaErrorInitializationError);

  Params p = {};
  for (int k = 0; k < n_hyper; ++k) p.h[k] = hyper[k];
  p.w = w;
  p.w_stride = w_stride / pl.e;
  for (int k = 0; k < n_slots; ++k) {
    p.s[k] = static_cast<float*>(slots[k]);
    p.s_stride[k] = k < wide_slots(rule) ? slot_strides[k] / pl.e
                                         : slot_strides[k];
  }
  p.rows = rows;
  p.ids64 = id_bytes == 8;
  p.g = grads;
  p.g_stride = static_cast<int>(g_stride / pl.e);
  p.counts = counts;
  p.n = n;
  p.n_rows = n_rows;
  p.m = oe_gather::row_map(static_cast<int>(dim / pl.e));
  p.tile = pl.tile;
  p.tiles = (n + pl.tile - 1) / pl.tile;
  const int64_t want = (p.tiles + kWarps - 1) / kWarps;
  const int blocks = want < resident ? static_cast<int>(want) : resident;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_instance(rule, bf16, pl.e, [&](auto inst) {
    using I = decltype(inst);
    fused_apply_kernel<I::R, typename I::T, I::E>
        <<<blocks, kThreads, 0, s>>>(p);
    return cudaSuccess;
  });
  return static_cast<int>(cudaGetLastError());
}

const char* oe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
