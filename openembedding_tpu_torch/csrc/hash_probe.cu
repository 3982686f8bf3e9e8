// The hashed pull's probe: find each id's slot in an open-addressing table
// of int64 keys (-1 empty), claiming an empty slot for an id that is not
// there, placed exactly as `tables/hash_table.py::hash_find_or_insert_reference`
// places it (64 rounds of torch ops, one probe distance a round; where ids
// claim one empty slot in the same round, the highest batch index wins).
//
// Replaces no Pallas kernel: the JAX package writes its probe in jnp
// (`openembedding_tpu/tables/hash_table.py:268-330`), and the port ran it as
// torch ops until this kernel pair took its place on the card.
//
// What bounds it on an H100: the dependent reads of the key array. An id in
// the table is found by one or two 8-byte reads from a key array of
// gigabytes (2 GB at 2^28 slots), each a 32-byte sector from device memory:
// about 72,000 distinct ids a batch of the Criteo flagship, 2.3-4.6 MB of
// sectors, a few microseconds. The torch-op rounds ran every round whatever
// the data (about 1,500 launches a step) and filled a claim buffer of one
// int32 a slot every call (1 GB at 2^28 slots).
//
// What the design does about it: it keeps the placement and touches only
// the entries that can change it.
// - The walk (one thread an entry) mixes its id's base slot and walks
//   `(base + d) % capacity` for d < num_probes, up to the first key equal
//   to the id (its slot) or the first empty key. That is exact: in the
//   rounds, an id that reaches distance d0 has passed only occupied slots
//   that are not its own, and a round only ever fills empty slots, so the
//   id reaches d0 at round d0 with nothing on its path changed. An id that
//   meets an empty key at d0 goes into a pending list with d0; an id that
//   spends the budget over occupied slots is an overflow.
// - The contest (one block) runs the rounds d = min(d0) ... num_probes - 1
//   for the pending ids alone; each pending id joins at its own d0 and
//   does what a round did: a key equal to the id is found (a table with
//   holes), an empty key is contended, anything else advances. A
//   contender writes the marker -2 - index over the empty key with
//   atomicMin: the smallest marker is the highest index, the rounds'
//   winner. After a barrier the contender whose marker stands writes its
//   id over it; a second barrier ends the round. A slot with markers has
//   exactly one winner, so no marker outlives its round, and a read that
//   sees a marker treats the slot as the empty slot it was at the round's
//   start. The rounds stop when every pending id is placed.
// - The contest is one block, so its barriers are __syncthreads: it needs
//   no co-resident grid, no cooperative launch, and cannot hang beside the
//   kernels of other streams (the mesh's side-stream prefetch next to
//   NCCL). What that costs falls on insert-heavy calls alone (a table's
//   first pass over its ids, a restore): the block's 1024 threads take the
//   pending ids in turn.
// - With no pending id (every id found: a pool the table has seen), the
//   contest returns at once.
//
// Plain C interface (bound from Python with ctypes in `ops/hash_probe.py`):
// the launches go on the caller's stream, do not synchronise, allocate
// nothing, read nothing back, and return cudaGetLastError() so the wrapper
// can raise on a refused launch. A CUDA graph captures them.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // a walk block
constexpr int kContestThreads = 1024;  // the contest's one block
constexpr long long kEmpty = -1;
constexpr unsigned long long kMixMul = 0xFF51AFD7ED558CCDull;
constexpr int kPlaced = INT_MAX;  // a pending entry's d0 once it has a slot

// int32 words of the scratch, zeroed by the wrapper before the walk
constexpr int kPending = 0;   // the pending list's length
constexpr int kOverflow = 1;  // non-negative ids left without a slot
constexpr int kInserted = 2;  // slots claimed
constexpr int kFar = 3;       // max over pending ids of num_probes - d0
constexpr int kScratchWords = 4;

// the JAX package's avalanche mixer on the id's uint64 bits
__device__ __forceinline__ unsigned long long mix64(unsigned long long u) {
  u = (u ^ (u >> 33)) * kMixMul;
  return u ^ (u >> 33);
}

__device__ __forceinline__ unsigned long long slot_at(long long id,
                                                      unsigned long long cap,
                                                      int d) {
  return (mix64(static_cast<unsigned long long>(id)) % cap + d) % cap;
}

// a read that no cache between the SM and L2 may answer from an old copy:
// the contest's keys change between its rounds (its atomics act in L2)
template <typename T>
__device__ __forceinline__ T fresh(const T* p) {
  return *reinterpret_cast<const volatile T*>(p);
}

__global__ void __launch_bounds__(kThreads)
walk_kernel(const long long* __restrict__ keys, unsigned long long cap,
            const long long* __restrict__ ids, int n, int num_probes,
            long long* __restrict__ slot, int* __restrict__ pend_index,
            int* __restrict__ pend_d0, int* __restrict__ scratch) {
  const long long at_i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int i = static_cast<int>(at_i);
  bool pend = false, lost = false;
  int d = 0;
  if (at_i < n) {
    const long long id = ids[i];
    long long out = static_cast<long long>(cap);
    if (id >= 0) {
      unsigned long long pos = mix64(static_cast<unsigned long long>(id))
                               % cap;
      for (; d < num_probes; ++d) {
        const long long cur = __ldg(keys + pos);
        if (cur == id) {
          out = static_cast<long long>(pos);
          break;
        }
        if (cur == kEmpty) {
          pend = true;
          break;
        }
        if (++pos == cap) pos = 0;
      }
      lost = !pend && out == static_cast<long long>(cap);
    }
    slot[i] = out;
  }
  // one atomic a warp for the list, the first round and the overflow
  const unsigned int want = __ballot_sync(0xffffffffu, pend);
  const unsigned int over = __ballot_sync(0xffffffffu, lost);
  const int far = __reduce_max_sync(0xffffffffu, pend ? num_probes - d : 0);
  const int lane = threadIdx.x & 31;
  if (want) {
    const int leader = __ffs(want) - 1;
    int at = 0;
    if (lane == leader) {
      at = atomicAdd(scratch + kPending, __popc(want));
      atomicMax(scratch + kFar, far);
    }
    at = __shfl_sync(0xffffffffu, at, leader);
    if (pend) {
      at += __popc(want & ((1u << lane) - 1u));
      pend_index[at] = i;
      pend_d0[at] = d;
    }
  }
  if (over && lane == __ffs(over) - 1) {
    atomicAdd(scratch + kOverflow, __popc(over));
  }
}

__global__ void __launch_bounds__(kContestThreads)
contest_kernel(long long* keys, unsigned long long cap,
               const long long* __restrict__ ids, int num_probes,
               long long* __restrict__ slot,
               const int* __restrict__ pend_index, int* __restrict__ pend_d0,
               int* scratch) {
  const int n_pend = scratch[kPending];
  if (n_pend == 0) return;
  __shared__ int counts[2];  // inserted, overflow
  if (threadIdx.x == 0) counts[0] = counts[1] = 0;
  int inserted = 0, left = 0;
  // entry k stays with thread k % kContestThreads for the whole launch, so
  // its d0 (kPlaced once it has a slot) is this thread's to read and write
  for (int d = num_probes - scratch[kFar]; d < num_probes; ++d) {
    // the round's reads: found, contend, or advance
    for (int k = threadIdx.x; k < n_pend; k += kContestThreads) {
      if (pend_d0[k] > d) continue;
      const int i = pend_index[k];
      const long long id = ids[i];
      const unsigned long long pos = slot_at(id, cap, d);
      const long long cur = fresh(keys + pos);
      if (cur == id) {
        slot[i] = static_cast<long long>(pos);
        pend_d0[k] = kPlaced;
      } else if (cur < 0) {  // empty at the round's start, maybe marked
        atomicMin(keys + pos, -2 - static_cast<long long>(i));
      }
    }
    __syncthreads();
    // the contest's winners take their slots
    left = 0;
    for (int k = threadIdx.x; k < n_pend; k += kContestThreads) {
      const int d0 = pend_d0[k];
      if (d0 == kPlaced) continue;
      if (d0 <= d) {
        const int i = pend_index[k];
        const long long id = ids[i];
        const unsigned long long pos = slot_at(id, cap, d);
        if (fresh(keys + pos) == -2 - static_cast<long long>(i)) {
          keys[pos] = id;
          slot[i] = static_cast<long long>(pos);
          pend_d0[k] = kPlaced;
          ++inserted;
          continue;
        }
      }
      ++left;
    }
    if (!__syncthreads_or(left)) break;  // every pending id placed
  }
  // `left`: this thread's ids still unplaced after the last round
  if (inserted) atomicAdd(counts, inserted);
  if (left) atomicAdd(counts + 1, left);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (counts[0]) atomicAdd(scratch + kInserted, counts[0]);
    if (counts[1]) atomicAdd(scratch + kOverflow, counts[1]);
  }
}

}  // namespace

extern "C" {

// The int32 words of scratch the launches take: zeroed before the walk.
int oe_hash_probe_scratch_words() { return kScratchWords; }

// keys: (capacity,) int64, updated in place; ids: (n,) int64; slot: (n,)
// int64 out; pend_index, pend_d0: (n,) int32 scratch; scratch: the zeroed
// words above, whose kPending, kOverflow and kInserted words hold the
// counts when the contest ends. Launches the walk, then the contest, on
// `stream`. Returns a cudaError_t.
int oe_hash_probe(void* keys, int64_t capacity, const void* ids, int64_t n,
                  int num_probes, void* slot, void* pend_index, void* pend_d0,
                  void* scratch, void* stream) {
  if (capacity <= 0 || n < 0 || n > INT_MAX || num_probes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int count = static_cast<int>(n);
  const unsigned long long cap = static_cast<unsigned long long>(capacity);
  const int walk_blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  walk_kernel<<<walk_blocks, kThreads, 0, s>>>(
      static_cast<const long long*>(keys), cap,
      static_cast<const long long*>(ids), count, num_probes,
      static_cast<long long*>(slot), static_cast<int*>(pend_index),
      static_cast<int*>(pend_d0), static_cast<int*>(scratch));
  cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  contest_kernel<<<1, kContestThreads, 0, s>>>(
      static_cast<long long*>(keys), cap,
      static_cast<const long long*>(ids), num_probes,
      static_cast<long long*>(slot), static_cast<const int*>(pend_index),
      static_cast<int*>(pend_d0), static_cast<int*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

const char* oe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
