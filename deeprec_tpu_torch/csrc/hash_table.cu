// K4 and K5: the hash index's probe loops (sparse/hashtable.py lookup and
// lookup_or_insert) on the card.
//
// Neither has a Pallas counterpart: the JAX package runs both loops as
// device while_loops (deeprec_tpu/sparse/hashtable.py lookup, :147, and
// lookup_or_insert, :231), which never come back to the host. These
// kernels replace the port's plain versions (hashtable.py lookup_plain and
// lookup_or_insert_plain), whose Python loops ask the host each round
// whether a key is left. Both reproduce the JAX table bit for bit: the
// same hash, geometry, probe order and claim arbitration.
//
// Layout (as the JAX table): the key plane is int64 [cap], EMPTY (-1)
// where free, cut into buckets of w = min(16, cap) consecutive slots. A key
// probes bucket (home + off * step) & bmask at offset off, home =
// hash32(key) & bmask, step = (hash32(key, 7) | 1) & bmask; uint32
// arithmetic keeps the low bits of that sum whatever the width. Slot cap
// is the null row of the row stores: misses, padding and failed inserts.
//
// What bounds them on Hopper: a probe is one dependent 128-byte read per
// key (16 int64 lanes), so at the shapes of the main paths (5,195-106,496
// keys) the launch and one or two round trips to memory; K5 adds its
// grid barriers and the copy of the key plane (16.8 MB at 2^21 slots) that
// its callers rely on (the input table stays as it was). The design:
// - A half-warp takes a key, one lane a slot of its bucket: each probe is
//   one coalesced 128-byte read, and two __ballot_syncs over the half's
//   lanes give the matching and the empty lanes (the lowest set lane is the
//   JAX table's first lane). Keys stride over the half-warps of the grid.
// - K4 (lookup) is one ordinary launch: each key probes on its own until a
//   match, a bucket with an empty lane (absence proven) or max_probes.
// - K5 (lookup_or_insert) runs the JAX rounds exactly, in one cooperative
//   launch sized to the blocks the card holds at once (a grid barrier needs
//   every block resident). Each round: read (every pending key reads its
//   bucket as it stood at the end of the last round: nothing writes the
//   plane in this phase); hit; claim (a key whose bucket has an empty lane
//   atomicMaxes ~rank into an arbitration word of the first empty slot, so
//   the lowest rank wins; rank is the lane index in ukeys); advance (a full
//   bucket moves the key on); barrier; commit (the winner writes its key,
//   losers stay on their bucket, keys past max_probes stop); a per-round
//   count of the keys still pending; barrier; stop at 0 or after
//   max_probes + w rounds. A slot is claimed in at most one round (its
//   winner fills it), so the arbitration words are zeroed once a call and
//   never reset. Before the first round the kernel copies the plane,
//   zeroes the words and sets each key's state; after the last it adds the
//   created and the failed keys to size and overflow. Every read of what
//   another block wrote in an earlier phase goes through L2 (__ldcg): L1 is
//   not coherent across SMs.
// - K5 is launched ordinarily (not as a programmatic dependent) and never
//   triggers its dependents early: K3a and K1, programmatic dependents
//   launched after it, read its slots after it has finished.
// Making K5 fast (fewer barriers, a grid sized to the keys, a first round
// that resolves every present key without the plane copy) is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {
namespace ht {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int64_t kEmpty = -1;
// K5's per-key states
constexpr int kDone = 0, kPending = 1, kWant = 2;

// sparse/keys.py hash32: a Murmur3-style finalizer of the two halves.
__device__ __forceinline__ uint32_t hash32(int64_t key, uint32_t seed) {
  const uint32_t hi = (uint32_t)((uint64_t)key >> 32);
  const uint32_t lo = (uint32_t)key;
  uint32_t h = lo ^ (hi * 0x85EBCA6Bu) ^ (seed * 0x9E3779B9u);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// 64-bit loads: through the read-only cache (a plane nothing writes), and
// through L2 only (what another block wrote before a grid barrier).
__device__ __forceinline__ int64_t ld_nc(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}
__device__ __forceinline__ int64_t ld_l2(const int64_t* p) {
  return (int64_t)__ldcg(reinterpret_cast<const long long*>(p));
}

// The first slot of the bucket a key probes at offset off.
__device__ __forceinline__ int64_t bucket_base(int64_t key, int off, int w,
                                               uint32_t bmask) {
  const uint32_t home = hash32(key, 0) & bmask;
  const uint32_t step = (hash32(key, 7) | 1u) & bmask;
  return (int64_t)((home + (uint32_t)off * step) & bmask) * w;
}

// Over the 16 lanes of this thread's half-warp (all of them call it): the
// lanes, below w, whose slot holds `key` and those that are empty.
__device__ __forceinline__ void probe_masks(int64_t kw, int64_t key, int w,
                                            unsigned* match,
                                            unsigned* empty) {
  const int l = threadIdx.x & 15;
  const unsigned shift = threadIdx.x & 16;
  const unsigned half = 0xFFFFu << shift;
  *match = (__ballot_sync(half, l < w && kw == key) >> shift) & 0xFFFFu;
  *empty = (__ballot_sync(half, l < w && kw == kEmpty) >> shift) & 0xFFFFu;
}

// K4: (slots, found) for n keys; one half-warp a key.
__global__ void __launch_bounds__(kThreads) lookup_kernel(
    const int64_t* __restrict__ plane, int64_t cap, int w, uint32_t bmask,
    const int64_t* __restrict__ keys, int64_t n, int max_probes,
    int64_t* __restrict__ slots, bool* __restrict__ found) {
  const int l = threadIdx.x & 15;
  const int64_t halves = (int64_t)gridDim.x * (kThreads / 16);
  for (int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 4;
       i < n; i += halves) {  // the same i on the half's 16 lanes
    const int64_t key = keys[i];
    int64_t slot = cap;
    if (key != kEmpty) {  // EMPTY keys are never found
      for (int off = 0; off < max_probes; ++off) {
        const int64_t base = bucket_base(key, off, w, bmask);
        const int64_t kw = l < w ? ld_nc(plane + base + l) : 0;
        unsigned match, empty;
        probe_masks(kw, key, w, &match, &empty);
        if (match) {
          slot = base + __ffs(match) - 1;
          break;
        }
        if (empty) break;  // a bucket with an empty lane proves absence
      }
    }
    if (l == 0) {
      slots[i] = slot;
      found[i] = slot != cap;
    }
  }
}

// Sum of v over the block, in thread 0.
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v) {
  __shared__ unsigned long long part[kWarps];
  __syncthreads();  // part may still be read by the last call
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long s = 0;
  if (threadIdx.x == 0)
    for (int k = 0; k < kWarps; ++k) s += part[k];
  return s;
}

// K5. scratch (int32): state [n], off [n], target [n] (the claimed slot),
// arb [cap] (the arbitration words), pending [max_rounds] (the count of
// keys left after each round); the kernel initialises all of it.
__global__ void __launch_bounds__(kThreads) lookup_or_insert_kernel(
    const int64_t* __restrict__ plane_in, int64_t* plane, int64_t cap, int w,
    uint32_t bmask, const int64_t* __restrict__ ukeys, int64_t n,
    int max_probes, int max_rounds, const int64_t* __restrict__ size_in,
    const int64_t* __restrict__ overflow_in, int64_t* size,
    int64_t* overflow, int64_t* slots, bool* created, int32_t* scratch) {
  cg::grid_group grid = cg::this_grid();
  int32_t* state = scratch;
  int32_t* off = state + n;
  int32_t* target = off + n;
  uint32_t* arb = reinterpret_cast<uint32_t*>(target + n);
  uint32_t* pending = arb + cap;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  const int l = threadIdx.x & 15;

  // the plane's copy, zeroed arbitration words and counts, each key's state
  for (int64_t j = tid; j < cap; j += threads) {
    plane[j] = plane_in[j];
    arb[j] = 0;
  }
  for (int64_t j = tid; j < max_rounds; j += threads) pending[j] = 0;
  if (tid == 0) {
    *size = *size_in;
    *overflow = *overflow_in;
  }
  for (int64_t i = tid; i < n; i += threads) {
    state[i] = ukeys[i] != kEmpty ? kPending : kDone;
    off[i] = 0;
    slots[i] = cap;
    created[i] = false;
  }
  unsigned long long made = 0;  // the keys this thread's lanes created
  grid.sync();

  for (int r = 0; r < max_rounds; ++r) {
    // read, hit, claim, advance: one half-warp a key
    for (int64_t i = tid >> 4; i < n; i += threads >> 4) {
      if (__ldcg(state + i) != kPending) continue;  // the same on the half
      const int64_t key = ukeys[i];
      const int o = __ldcg(off + i);
      const int64_t base = bucket_base(key, o, w, bmask);
      const int64_t kw = l < w ? ld_l2(plane + base + l) : 0;
      unsigned match, empty;
      probe_masks(kw, key, w, &match, &empty);
      if (l == 0) {
        if (match) {  // a key stored before this call (keys are unique)
          slots[i] = base + __ffs(match) - 1;
          state[i] = kDone;
        } else if (empty) {  // the first empty lane; the lowest rank wins
          const int64_t t = base + __ffs(empty) - 1;
          target[i] = (int32_t)t;
          atomicMax(arb + t, ~(uint32_t)i);
          state[i] = kWant;
        } else {  // a full bucket: the next one next round
          off[i] = o + 1;
        }
      }
    }
    grid.sync();
    // commit: one thread a key
    unsigned long long left = 0;
    for (int64_t i = tid; i < n; i += threads) {
      int s = __ldcg(state + i);
      if (s == kDone) continue;
      if (s == kWant) {
        const int32_t t = __ldcg(target + i);
        if (__ldcg(arb + t) == ~(uint32_t)i) {
          plane[t] = ukeys[i];
          slots[i] = t;
          created[i] = true;
          state[i] = kDone;
          ++made;
          continue;
        }
        s = kPending;  // lost: the same bucket next round
      }
      // past the probe bound a key can neither match nor claim
      if (__ldcg(off + i) >= max_probes) s = kDone;
      else ++left;
      state[i] = s;
    }
    const unsigned long long sum = block_sum(left);
    if (threadIdx.x == 0 && sum) atomicAdd(pending + r, (uint32_t)sum);
    grid.sync();
    if (__ldcg(pending + r) == 0) break;  // the same in every thread
  }

  // size += created, overflow += the valid keys left without a slot
  unsigned long long failed = 0;
  for (int64_t i = tid; i < n; i += threads)
    failed += ukeys[i] != kEmpty && ld_l2(slots + i) == cap;
  const unsigned long long m = block_sum(made);
  const unsigned long long f = block_sum(failed);
  if (threadIdx.x == 0) {
    if (m) atomicAdd(reinterpret_cast<unsigned long long*>(size), m);
    if (f) atomicAdd(reinterpret_cast<unsigned long long*>(overflow), f);
  }
}

// The card's SM count, taken once a device.
int sm_count() {
  static int cached[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// Resident blocks of `kernel` on one SM (the same on every SM of a card;
// the cards of one process are taken to be of one kind).
template <typename F>
int resident_blocks(F kernel, int* cached) {
  if (*cached == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(cached, kernel, kThreads,
                                                  0);
  return *cached;
}

// The bucket geometry: w lanes a bucket, the bucket mask.
void geometry(int64_t cap, int* w, uint32_t* bmask) {
  *w = cap < 16 ? (int)cap : 16;
  *bmask = (uint32_t)(cap / *w - 1);
}

}  // namespace ht
}  // namespace

// K4. Launches on `stream`, never syncs; returns the launch's cudaError_t.
extern "C" int deeprec_hash_lookup(const void* plane, int64_t cap,
                                   const void* keys, int64_t n,
                                   int max_probes, void* slots, void* found,
                                   void* stream) {
  if (n == 0) return 0;
  int w;
  uint32_t bmask;
  ht::geometry(cap, &w, &bmask);
  static int per_sm = 0;
  const int64_t wave =
      (int64_t)ht::sm_count() *
      ht::resident_blocks(ht::lookup_kernel, &per_sm);
  int64_t blocks = (n * 16 + ht::kThreads - 1) / ht::kThreads;
  if (wave > 0 && blocks > wave) blocks = wave;
  ht::lookup_kernel<<<(unsigned)blocks, ht::kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int64_t*)plane, cap, w, bmask, (const int64_t*)keys, n,
      max_probes, (int64_t*)slots, (bool*)found);
  return (int)cudaGetLastError();
}

// K5. scratch: int32 [3 n + cap + max_probes + w]. Launches on `stream`,
// cooperatively, never syncs; returns the launch's cudaError_t.
extern "C" int deeprec_hash_lookup_or_insert(
    const void* plane_in, void* plane, int64_t cap, const void* ukeys,
    int64_t n, int max_probes, const void* size_in, const void* overflow_in,
    void* size, void* overflow, void* slots, void* created, void* scratch,
    void* stream) {
  if (n == 0) return 0;
  int w;
  uint32_t bmask;
  ht::geometry(cap, &w, &bmask);
  static int per_sm = 0;
  const int64_t blocks =
      (int64_t)ht::sm_count() *
      ht::resident_blocks(ht::lookup_or_insert_kernel, &per_sm);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(ht::kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, ht::lookup_or_insert_kernel, (const int64_t*)plane_in,
      (int64_t*)plane, cap, w, bmask, (const int64_t*)ukeys, n, max_probes,
      max_probes + w, (const int64_t*)size_in, (const int64_t*)overflow_in,
      (int64_t*)size, (int64_t*)overflow, (int64_t*)slots, (bool*)created,
      (int32_t*)scratch);
}
