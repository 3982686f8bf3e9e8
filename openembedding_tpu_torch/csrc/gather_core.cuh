// The row-copy core that both row gathers share (`gather_rows.cu`,
// `gather_rows_windows.cu`): one warp copies a tile of up to 32 rows,
// given one key per row, into 32 * rows consecutive output words. The
// fused apply (`fused_sparse_apply.cu`) walks its tiles with the same
// lane map (`RowMap`, `Cursor`, `advance`, `tile_rows`).
//
// - Ids are read once per row: lane i holds row i's key (computed by the
//   caller from a coalesced id load, range-checked there once), and the
//   lanes that copy the row's words get it with `__shfl_sync`.
// - The tile's words are numbered row-major and word e goes to lane
//   e % 32, so every lane works and the stores are contiguous. A lane
//   walks its words with a cursor (row, word) advanced by the per-launch
//   constants 32 / rw and 32 % rw: no division in the copy loop, and all
//   index math in a tile is 32-bit. The one 64-bit product per row
//   (id * words per row) is the caller's.
// - kUnroll words a lane: all of them are loaded before any is stored, so
//   a lane has up to kUnroll row loads in flight (the TPU kernel's ring of
//   DMAs). A tile of at most 32 * kUnroll words is one such round.
// - Stores stream (`st.global.cs`): the output is written once and read by
//   the next kernel, so it should not evict the table's hot rows from L2.
// - Rows move as raw words (2, 4, 8 or 16 bytes; the caller picks the
//   widest that divides the row bytes and both base addresses), so
//   bfloat16 rows, NaN payloads and -0.0 are copied bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace oe_gather {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 8;  // words a lane loads before it stores

// Keys: >= 0 is the row's first word in the source; these two are not.
constexpr long long kZero = -1;  // write a +0.0 row
constexpr long long kSkip = -2;  // leave the output row as it is

// Per-launch constants of the lane -> (row, word) map: rw words a row.
struct RowMap {
  int rw;
  int q32;  // 32 / rw
  int r32;  // 32 % rw
};

inline RowMap row_map(int rw) { return RowMap{rw, 32 / rw, 32 % rw}; }

// Rows a tile holds so that its words are one round of `unroll` per lane.
inline int tile_rows(int rw, int unroll = kUnroll) {
  const int t = 32 * unroll / rw;
  return t < 1 ? 1 : (t > 32 ? 32 : t);
}

// A lane's position in the tile: the row and word of its next word.
struct Cursor {
  int row;
  int word;
};

// The lane's first word (word `lane`); one division per thread, done once.
__device__ __forceinline__ Cursor first_word(const RowMap& m) {
  const int lane = threadIdx.x & 31;
  return Cursor{lane / m.rw, lane % m.rw};
}

// Move the cursor on by 32 words (to this lane's next word).
__device__ __forceinline__ void advance(Cursor& c, const RowMap& m) {
  c.word += m.r32;
  c.row += m.q32;
  if (c.word >= m.rw) {
    c.word -= m.rw;
    ++c.row;
  }
}

// Word rows from the table in device memory.
template <typename Word>
struct TableRows {
  const Word* __restrict__ w;
  __device__ __forceinline__ Word operator()(long long key, int word) const {
    return __ldg(w + key + word);
  }
};

// Word rows from a staging buffer in shared memory.
template <typename Word>
struct StagedRows {
  const Word* s;
  __device__ __forceinline__ Word operator()(long long key, int word) const {
    return s[static_cast<int>(key) + word];
  }
};

// Copy a tile of `rows` rows (1..32, the same in every lane; all 32 lanes
// call): lane i < rows holds row i's key; out points at the tile's first
// output word. Row i's words go to out[i * rw, (i + 1) * rw).
template <typename Word, typename Load>
__device__ __forceinline__ void copy_tile(long long key, int rows,
                                          const RowMap& m, Cursor c,
                                          Word* __restrict__ out,
                                          const Load& load) {
  const int lane = threadIdx.x & 31;
  const int total = rows * m.rw;
  for (int e0 = 0; e0 < total; e0 += 32 * kUnroll) {
    Word v[kUnroll];
    unsigned store = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = __shfl_sync(kFull, key, c.row & 31);
      const bool in_tile = e0 + u * 32 + lane < total;
      v[u] = Word{};
      if (in_tile && k >= 0) v[u] = load(k, c.word);
      if (in_tile && k != kSkip) store |= 1u << u;
      advance(c, m);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (store & (1u << u)) __stcs(out + e0 + u * 32 + lane, v[u]);
    }
  }
}

inline bool aligned(const void* p, size_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

// The widest word (16, 8, 4 or 2 bytes) that divides the row and the table
// and output addresses.
inline int word_bytes(int64_t row_bytes, const void* w, const void* out) {
  for (int b = 16; b > 2; b /= 2) {
    if (row_bytes % b == 0 && aligned(w, b) && aligned(out, b)) return b;
  }
  return 2;
}

}  // namespace oe_gather
