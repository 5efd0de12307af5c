// K4 and K5: the hash index's probe loops (sparse/hashtable.py lookup and
// lookup_or_insert_) on the card.
//
// Neither has a Pallas counterpart: the JAX package runs both loops as
// device while_loops (deeprec_tpu/sparse/hashtable.py lookup, :147, and
// lookup_or_insert, :231), which never come back to the host. These
// kernels replace the port's plain versions (hashtable.py lookup_plain and
// lookup_or_insert_plain_), whose Python loops ask the host each round
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
// What bounds them on Hopper: a probe is one 128-byte bucket read (16 int64
// lanes) that depends on the key's own load, so at the shapes of the main
// paths (5,195-106,496 keys) the launch and a few round trips to memory, not
// bytes; K5 adds its grid barriers. The design:
// - A half-warp probes for a run of kRun consecutive keys (4 in both
//   kernels), lane m holding key m: the run's keys come in one coalesced
//   load, then the half issues the bucket reads of all of the run's keys
//   (one coalesced 128-byte read each, a lane a slot) before its first
//   compare (probe_run). So a half has kRun reads in flight, and the key
//   load's round trip is paid once a run. Two __ballot_syncs over the
//   half's lanes give a bucket's matching and empty lanes (the lowest set
//   lane is the JAX table's first lane). Runs stride over the half-warps of
//   the grid. Longer runs (8, 16) lost on the card: more compares in
//   series a half and fewer halves at work.
// - K4 (lookup) is one launch, a programmatic dependent (launch.cuh): it
//   waits for the work before it ahead of its first read (its outputs may
//   be blocks the allocator just reused) and lets the kernel after it start
//   once its first bucket reads are in. The home buckets go through
//   probe_run; a key whose home bucket is full without it probes on, a key
//   at a time, until a match, a bucket with an empty lane (absence proven)
//   or max_probes (rare at serving load).
// - K5 (lookup_or_insert_) writes the key plane, size and overflow in
//   place: its callers give up the index they pass (the JAX step donates
//   its state), so it copies nothing; hashtable.lookup_or_insert, the
//   functional form, clones the table first. It runs the JAX rounds
//   exactly, in one cooperative launch on at most the blocks the card holds
//   at once (a grid barrier needs every block resident), sized to the keys.
//   Each round: read (the keys still pending probe the plane as it stood at
//   the end of the last round, through probe_run: nothing writes the plane
//   in this phase); hit; claim (a key whose bucket has an empty lane
//   atomicMaxes ~rank into the arbitration word of the first empty slot, so
//   the lowest rank wins; rank is the lane index in ukeys); advance (a full
//   bucket moves the key on); grid barrier; commit (the winner writes its
//   key and resets its word, losers stay on their bucket, keys past
//   max_probes stop); grid barrier. Round 0 sets each key's outputs and
//   state itself (no barrier before it), and counts the keys that claimed
//   or advanced: where none did, every key was found and the kernel ends
//   after its first barrier, the steady step's one barrier. Later, each
//   barrier reads a count (keys that claimed or advanced, keys left), and a
//   0 ends the kernel; the rounds stop after max_probes + w.
// - Per-key state (state, offset, claimed slot) is private to one thread,
//   the lane that owns the key in both phases, so it is read back through
//   L1. What another block wrote before a barrier (the plane, the
//   arbitration words, the counts) is read through L2 (__ldcg): L1 is not
//   coherent across SMs.
// - Nothing is zeroed per call. The arbitration words ([cap], cached by
//   ops/hash_probe.py per device, capacity and stream and zeroed once) are
//   all 0 again when a call ends: a slot is claimed in one round at most
//   (its winner fills it), every claimed word has exactly one winner, and
//   the winner resets its word in the commit; a loser that reads 0 after
//   that loses, as ~rank is never 0 for n < 2^31. The counts after the
//   words alternate between two pairs of words: a pair is reset in the
//   commit of the round after its own (once every block has read it), and
//   the last block to leave resets them all.
// - K5 is launched ordinarily and never triggers its dependents early: K3a
//   and K1, programmatic dependents launched after it, read its slots after
//   it has finished. (Launched as a programmatic dependent itself, it
//   measured no faster on the card.)
// The previous designs (K4 a key a half-warp; K5 copying the plane and
// zeroing the words each call, three barriers on a steady step) are
// variants 0 of the design probe's K4 and K5 (probes/kernel_probe.cu), which
// times them beside these.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {
namespace ht {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalves = kThreads / 16;
// keys a half-warp (the design probe's K4 and K5 variants time 1-16)
constexpr int kLookupRun = 4;  // K4's
constexpr int kInsertRun = 4;  // K5's
constexpr int64_t kEmpty = -1;
// K5's per-key states, in the low two bits of the state word (the probe
// offset above them)
constexpr unsigned kDone = 0, kPending = 1, kWant = 2;
// K5's counts after the arbitration words: [0, 1] the keys that claimed or
// advanced in a read phase, [2, 3] the keys left after a commit (round r
// uses word r & 1 of each), [4] the blocks that have left
constexpr int kCountWords = 5;

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

// 64-bit loads: through the read-only cache (what nothing writes during
// the kernel), and through L2 only (what another block wrote before a grid
// barrier).
__device__ __forceinline__ int64_t ld_nc(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}
__device__ __forceinline__ int64_t ld_l2(const int64_t* p) {
  return (int64_t)__ldcg(reinterpret_cast<const long long*>(p));
}

// The first slot of the bucket a key probes at offset off.
__device__ __forceinline__ int64_t bucket_base(int64_t key, unsigned off,
                                               int w, uint32_t bmask) {
  const uint32_t home = hash32(key, 0) & bmask;
  const uint32_t step = (hash32(key, 7) | 1u) & bmask;
  return (int64_t)((home + off * step) & bmask) * w;
}

// This thread's half-warp: its 16 lanes in the warp's masks.
__device__ __forceinline__ unsigned half_mask() {
  return 0xFFFFu << (threadIdx.x & 16);
}
// The lanes of this thread's half-warp (all of them call it) where pred
// holds, as bits 0-15.
__device__ __forceinline__ unsigned half_ballot(bool pred) {
  return (__ballot_sync(half_mask(), pred) >> (threadIdx.x & 16)) & 0xFFFFu;
}

// Over the half-warp (all of it calls it): the lanes, below w, whose slot
// holds `key` and those that are empty, kw being this lane's slot.
__device__ __forceinline__ void probe_masks(int64_t kw, int64_t key, int w,
                                            unsigned* match,
                                            unsigned* empty) {
  const int l = threadIdx.x & 15;
  *match = half_ballot(l < w && kw == key);
  *empty = half_ballot(l < w && kw == kEmpty);
}

// The multi-key probe, over the half-warp (all of it calls it): each lane
// m < kRun set in `todo` holds a key and the first slot of the bucket it
// probes in `key` and `base`. Issues the bucket reads of all of them before
// the first compare; returns in lane m the lanes of its bucket that hold its
// key and those that are empty. kL2: read the plane through L2 (K5, whose
// plane other blocks write) rather than the read-only cache (K4).
template <int kRun, bool kL2>
__device__ __forceinline__ void probe_run(const int64_t* plane, int w,
                                          unsigned todo, int64_t key,
                                          int64_t base, unsigned* match,
                                          unsigned* empty) {
  const int l = threadIdx.x & 15;
  const unsigned half = half_mask();
  int64_t kw[kRun];
#pragma unroll
  for (int m = 0; m < kRun; ++m) {
    const int64_t b = __shfl_sync(half, base, m, 16);
    const int64_t* p = plane + b + l;
    kw[m] = 0;
    if (((todo >> m) & 1u) && l < w) kw[m] = kL2 ? ld_l2(p) : ld_nc(p);
  }
  *match = *empty = 0;
#pragma unroll
  for (int m = 0; m < kRun; ++m) {
    if ((todo >> m) & 1u) {  // the same on the half
      const int64_t km = __shfl_sync(half, key, m, 16);
      unsigned mt, em;
      probe_masks(kw[m], km, w, &mt, &em);
      if (l == m) {
        *match = mt;
        *empty = em;
      }
    }
  }
}

// K4: (slots, found) for n keys; a half-warp a run of kRun keys.
template <int kRun>
__global__ void __launch_bounds__(kThreads) lookup_kernel(
    const int64_t* __restrict__ plane, int64_t cap, int w, uint32_t bmask,
    const int64_t* __restrict__ keys, int64_t n, int max_probes,
    int64_t* __restrict__ slots, bool* __restrict__ found) {
  wait_for_prerequisite();  // every thread, before any access to memory
  const int l = threadIdx.x & 15;
  const int64_t halves = (int64_t)gridDim.x * kHalves;
  const int64_t runs = (n + kRun - 1) / kRun;
  bool first = true;
  for (int64_t q = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 4;
       q < runs; q += halves) {  // the same q on the half's 16 lanes
    const int64_t i = q * kRun + l;
    const bool mine = l < kRun && i < n;
    const int64_t key = mine ? ld_nc(keys + i) : kEmpty;
    // EMPTY keys are never found; max_probes 0 probes nothing
    const bool live = key != kEmpty && max_probes > 0;
    const int64_t base = live ? bucket_base(key, 0, w, bmask) : 0;
    const unsigned todo = half_ballot(live);
    unsigned match = 0, empty = 0;
    if (todo)
      probe_run<kRun, false>(plane, w, todo, key, base, &match, &empty);
    if (first) {
      launch_dependents();
      first = false;
    }
    int64_t slot = match ? base + __ffs(match) - 1 : cap;
    // a full home bucket without the key: the next buckets, a key at a time
    unsigned more = max_probes > 1 ? half_ballot(live && !match && !empty) : 0;
    while (more) {
      const int m = __ffs(more) - 1;
      more &= more - 1;
      const int64_t km = __shfl_sync(half_mask(), key, m, 16);
      int64_t s = cap;
      for (unsigned off = 1; off < (unsigned)max_probes; ++off) {
        const int64_t b = bucket_base(km, off, w, bmask);
        const int64_t kw = l < w ? ld_nc(plane + b + l) : 0;
        unsigned mt, em;
        probe_masks(kw, km, w, &mt, &em);
        if (mt) {
          s = b + __ffs(mt) - 1;
          break;
        }
        if (em) break;  // a bucket with an empty lane proves absence
      }
      if (l == m) slot = s;
    }
    if (mine) {
      slots[i] = slot;
      found[i] = slot != cap;
    }
  }
}

// Sum of v over the block, in thread 0 (every thread calls it).
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

// Adds v over the grid into *word, crosses a grid barrier and returns the
// total, the same in every thread (every thread calls it).
__device__ __forceinline__ uint32_t grid_count(cg::grid_group& grid,
                                               unsigned long long v,
                                               uint32_t* word) {
  __shared__ uint32_t total;
  const unsigned long long s = block_sum(v);
  if (threadIdx.x == 0 && s) atomicAdd(word, (uint32_t)s);
  grid.sync();
  if (threadIdx.x == 0) total = __ldcg(word);
  __syncthreads();
  return total;
}

// The block leaves: the last block out zeroes the counts for the next call
// (every block has read its last count by then).
__device__ __forceinline__ void leave(uint32_t* counts) {
  if (threadIdx.x != 0) return;
  __threadfence();
  if (atomicAdd(counts + kCountWords - 1, 1u) == gridDim.x - 1)
    for (int k = 0; k < kCountWords; ++k) counts[k] = 0;
}

// K5's read phase: every key still pending probes its bucket (a half-warp a
// run of kRun keys, lane m owning key m); hits, claims and advances. Round 0
// (kFirst) takes each key's state from its key and sets its outputs. Returns
// the keys of this thread that claimed or advanced.
template <int kRun, bool kFirst>
__device__ __forceinline__ unsigned long long read_phase(
    const int64_t* plane, int64_t cap, int w, uint32_t bmask,
    const int64_t* __restrict__ ukeys, int64_t n, int64_t* slots,
    bool* created, uint2* kst, uint32_t* arb) {
  const int l = threadIdx.x & 15;
  const int64_t halves = (int64_t)gridDim.x * kHalves;
  const int64_t runs = (n + kRun - 1) / kRun;
  unsigned long long act = 0;
  for (int64_t q = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 4;
       q < runs; q += halves) {  // the same q on the half's 16 lanes
    const int64_t i = q * kRun + l;
    const bool mine = l < kRun && i < n;
    const int64_t key = mine ? ld_nc(ukeys + i) : kEmpty;
    unsigned st = kDone, off = 0;
    if (kFirst) {
      st = key != kEmpty ? kPending : kDone;  // EMPTY keys are padding
    } else if (mine) {
      const unsigned word = kst[i].x;
      st = word & 3u;
      off = word >> 2;
    }
    const unsigned todo = half_ballot(st == kPending);
    unsigned match = 0, empty = 0;
    int64_t base = 0;
    if (todo) {
      if (st == kPending) base = bucket_base(key, off, w, bmask);
      probe_run<kRun, true>(plane, w, todo, key, base, &match, &empty);
    }
    unsigned target = 0;
    int64_t slot = cap;
    if (st == kPending) {
      if (match) {  // a key stored before this call (keys are unique)
        slot = base + __ffs(match) - 1;
        st = kDone;
      } else if (empty) {  // the first empty lane; the lowest rank wins
        target = (unsigned)(base + __ffs(empty) - 1);
        atomicMax(arb + target, ~(uint32_t)i);
        st = kWant;
        ++act;
      } else {  // a full bucket: the next one next round
        ++off;
        ++act;
      }
    }
    if (kFirst ? mine : (mine && ((todo >> l) & 1u))) {
      if (kFirst || slot != cap) slots[i] = slot;
      if (kFirst) created[i] = false;
      kst[i] = make_uint2(off << 2 | st, target);
    }
  }
  return act;
}

// K5's commit phase: a thread a key (the lane that owns it in the read
// phase). Winners write their key and reset their word; losers stay on
// their bucket; keys past the probe bound stop. Returns the keys of this
// thread left pending.
template <int kRun>
__device__ __forceinline__ unsigned long long commit_phase(
    int64_t* plane, int64_t n, int max_probes,
    const int64_t* __restrict__ ukeys, int64_t* slots, bool* created,
    uint2* kst, uint32_t* arb, unsigned long long* made,
    unsigned long long* failed) {
  const int l = threadIdx.x & 15;
  const int64_t halves = (int64_t)gridDim.x * kHalves;
  const int64_t runs = (n + kRun - 1) / kRun;
  unsigned long long left = 0;
  for (int64_t q = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 4;
       q < runs; q += halves) {
    const int64_t i = q * kRun + l;
    if (l >= kRun || i >= n) continue;
    const uint2 s = kst[i];
    unsigned st = s.x & 3u;
    const unsigned off = s.x >> 2;
    if (st == kDone) continue;
    if (st == kWant) {
      if (__ldcg(arb + s.y) == ~(uint32_t)i) {
        plane[s.y] = ld_nc(ukeys + i);
        slots[i] = s.y;
        created[i] = true;
        arb[s.y] = 0;  // no key claims this slot again: it is filled
        kst[i].x = kDone;
        ++*made;
        continue;
      }
      st = kPending;  // lost: the same bucket next round
    }
    // past the probe bound a key can neither match nor claim
    if (off >= (unsigned)max_probes) {
      st = kDone;
      ++*failed;
    } else {
      ++left;
    }
    kst[i].x = off << 2 | st;
  }
  return left;
}

// K5, a half-warp a run of kRun keys. kst: uint2 [n] (a key's state word
// and claimed slot; the kernel sets them). arb: uint32 [cap + kCountWords],
// all 0 on entry and again on exit.
template <int kRun>
__global__ void __launch_bounds__(kThreads) lookup_or_insert_kernel(
    int64_t* plane, int64_t cap, int w, uint32_t bmask,
    const int64_t* __restrict__ ukeys, int64_t n, int max_probes,
    int max_rounds, int64_t* size, int64_t* overflow, int64_t* slots,
    bool* created, uint2* kst, uint32_t* arb) {
  cg::grid_group grid = cg::this_grid();
  uint32_t* counts = arb + cap;
  unsigned long long made = 0, failed = 0;

  // round 0, then its barrier: where no key claimed or advanced, every key
  // was found (or was padding) and nothing changed
  unsigned long long act = read_phase<kRun, true>(
      plane, cap, w, bmask, ukeys, n, slots, created, kst, arb);
  if (grid_count(grid, act, counts) == 0) {
    leave(counts);
    return;
  }
  for (int r = 0;;) {
    const unsigned long long left = commit_phase<kRun>(
        plane, n, max_probes, ukeys, slots, created, kst, arb, &made,
        &failed);
    if (r > 0 && blockIdx.x == 0 && threadIdx.x == 0) {
      // every block read the last round's counts before this round's
      // first barrier; they are next added to after this round's second
      counts[(r - 1) & 1] = 0;
      counts[2 + ((r - 1) & 1)] = 0;
    }
    if (grid_count(grid, left, counts + 2 + (r & 1)) == 0) break;
    if (++r == max_rounds) {  // the keys still pending fail
      failed += left;
      break;
    }
    act = read_phase<kRun, false>(plane, cap, w, bmask, ukeys, n, slots,
                                  created, kst, arb);
    if (grid_count(grid, act, counts + (r & 1)) == 0) break;  // all found
  }

  // size += created, overflow += the valid keys left without a slot
  const unsigned long long m = block_sum(made);
  const unsigned long long f = block_sum(failed);
  if (threadIdx.x == 0) {
    if (m) atomicAdd(reinterpret_cast<unsigned long long*>(size), m);
    if (f) atomicAdd(reinterpret_cast<unsigned long long*>(overflow), f);
  }
  leave(counts);
}

// The bucket geometry: w lanes a bucket, the bucket mask.
void geometry(int64_t cap, int* w, uint32_t* bmask) {
  *w = cap < 16 ? (int)cap : 16;
  *bmask = (uint32_t)(cap / *w - 1);
}

// K4 with kRun keys a half-warp on at most one wave of blocks, as a
// programmatic dependent or (dependent false) an ordinary launch.
template <int kRun>
cudaError_t launch_lookup(const void* plane, int64_t cap, const void* keys,
                          int64_t n, int max_probes, void* slots, void* found,
                          cudaStream_t stream, bool dependent) {
  int w;
  uint32_t bmask;
  geometry(cap, &w, &bmask);
  static int per_sm = 0;
  const int64_t wave = (int64_t)sm_count() *
                       resident_blocks(lookup_kernel<kRun>, kThreads, &per_sm);
  const int64_t runs = (n + kRun - 1) / kRun;
  int64_t blocks = (runs + kHalves - 1) / kHalves;
  if (wave > 0 && blocks > wave) blocks = wave;
  const int64_t* p = (const int64_t*)plane;
  const int64_t* k = (const int64_t*)keys;
  if (dependent)
    return launch_dependent(lookup_kernel<kRun>, blocks, kThreads, stream, p,
                            cap, w, bmask, k, n, max_probes, (int64_t*)slots,
                            (bool*)found);
  lookup_kernel<kRun><<<(unsigned)blocks, kThreads, 0, stream>>>(
      p, cap, w, bmask, k, n, max_probes, (int64_t*)slots, (bool*)found);
  return cudaGetLastError();
}

// K5's grid: as many blocks as its runs of kRun keys need (full_grid:
// every block the card holds), at most the blocks resident at once; 0 where
// the card holds none.
template <int kRun>
int64_t insert_blocks(int64_t n, bool full_grid) {
  static int per_sm = 0;
  const int64_t resident =
      (int64_t)sm_count() *
      resident_blocks(lookup_or_insert_kernel<kRun>, kThreads, &per_sm);
  const int64_t runs = (n + kRun - 1) / kRun;
  const int64_t blocks = full_grid ? resident : (runs + kHalves - 1) / kHalves;
  return blocks < resident ? blocks : resident;
}

// K5 as one cooperative launch: a half-warp a run of kRun keys on
// insert_blocks(n, full_grid) blocks.
template <int kRun>
cudaError_t launch_insert(void* plane, int64_t cap, const void* ukeys,
                          int64_t n, int max_probes, void* size,
                          void* overflow, void* slots, void* created,
                          void* kst, void* arb, cudaStream_t stream,
                          bool full_grid) {
  int w;
  uint32_t bmask;
  geometry(cap, &w, &bmask);
  const int64_t blocks = insert_blocks<kRun>(n, full_grid);
  if (blocks <= 0) return cudaErrorInvalidConfiguration;
  return launch_cooperative(
      lookup_or_insert_kernel<kRun>, blocks, kThreads, stream,
      (int64_t*)plane, cap, w, bmask, (const int64_t*)ukeys, n, max_probes,
      max_probes + w, (int64_t*)size, (int64_t*)overflow, (int64_t*)slots,
      (bool*)created, (uint2*)kst, (uint32_t*)arb);
}

}  // namespace ht
}  // namespace

// K4. Launches on `stream`, never syncs; returns the launch's cudaError_t.
extern "C" int deeprec_hash_lookup(const void* plane, int64_t cap,
                                   const void* keys, int64_t n,
                                   int max_probes, void* slots, void* found,
                                   void* stream) {
  if (n == 0) return 0;
  return (int)ht::launch_lookup<ht::kLookupRun>(
      plane, cap, keys, n, max_probes, slots, found, (cudaStream_t)stream,
      true);
}

// K5, in place on plane, size and overflow. kst: 8 bytes a key of scratch
// (the kernel sets it); arb: uint32 [cap + 5], all 0 (and 0 again after).
// Launches on `stream`, cooperatively, never syncs; returns the launch's
// cudaError_t.
extern "C" int deeprec_hash_lookup_or_insert(
    void* plane, int64_t cap, const void* ukeys, int64_t n, int max_probes,
    void* size, void* overflow, void* slots, void* created, void* kst,
    void* arb, void* stream) {
  if (n == 0) return 0;
  return (int)ht::launch_insert<ht::kInsertRun>(
      plane, cap, ukeys, n, max_probes, size, overflow, slots, created, kst,
      arb, (cudaStream_t)stream, false);
}
