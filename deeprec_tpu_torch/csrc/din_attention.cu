// DIN's local activation unit (models/layers.py DINAttention.weights, also
// DIEN's DINAttentionScores), forward and backward, over the valid history
// positions only. For an example b with query q [g] and keys k_t [g] (f32,
// contiguous), at each position t where mask[b, t] holds:
//   x_t  = [q, k_t, q - k_t, q * k_t]                  [4g]
//   h1_t = sigmoid(W1 x_t + b1)                        W1 [h1, 4g]
//   h2_t = sigmoid(W2 h1_t + b2)                       W2 [h2, h1]
//   s_t  = (w3 . h2_t + b3) * scale                    scale 1 / sqrt(g)
//                                                      (DIN) or 1 (DIEN)
//   out[b, t] = exp(s_t - max) / sum over the valid positions of the same
// and out[b, t] = 0 at every padded position (a row with none: all 0).
//
// Replaces no TPU kernel: the JAX package leaves the unit to XLA. Done so
// in PyTorch, a DIEN step at B 16,384 and histories of 100 scores all 1.64 M
// positions (13.8 % of them valid) through [1.64 M, 144], [., 80] and
// [., 40] float32 tensors: a 944 MB cat, two GEMMs and their elementwise
// chains each way, and the backward's GEMMs over all positions besides;
// about 9-10 ms a step on an H100, against the 0.3 ms that the valid
// positions' 20 GFLOP take at the f32 peak.
//
// What bounds it: f32 FMAs on CUDA cores (no tensor cores, no TF32). A
// position reads its key, g floats, and costs about 9,000 FMAs forward
// and 27,000 backward at DIEN's widths, so nothing here waits on HBM but
// the backward's zero writes of the padded keys' gradients.
//
// Regrouped sums: the first layer's product is taken as
//   W1 x_t + b1 = [W1b - W1c | W1d] [k_t, q * k_t] + ((W1a + W1c) q + b1)
// (W1 = [W1a | W1b | W1c | W1d], g columns each): the query's share, the
// last term, once an example, and a 2g-wide product a position; the
// backward takes the first layer's parameter gradients and d_query from
// the same regrouping (dW1a = sum_b D_b q_b^T, dW1c = dW1a - dW1b, D_b the
// example's sum of the first layer's pre-activation gradients). That is
// the same mathematics with f32 sums in another order.
//
// Design: a block (320 threads forward, 512 backward) takes 32 consecutive
// examples, stages the weights in shared memory
// once (W' = [W1b - W1c | W1d] as [h1][2g] and W2 as given), works out
// each example's first-layer offset (W1a + W1c) q + b1, and writes each
// example's valid positions into scratch. It then walks them, in (example,
// t) order, in chunks of 64 positions, a chunk taking positions of several
// examples, so no thread works on a padded position. Chunk buffers in
// shared memory hold a feature's 64 values contiguous (rows of 68 floats:
// an odd number of float4s, so eight rows read at one column fall in eight
// bank groups). Every product is a loop of float4 loads that each feed
// four FMAs: a thread holds a 4 x 4 tile of outputs; the work items of a
// product run the positions fastest, so the eight threads of a quarter
// warp read one weight float4 (a broadcast) and eight consecutive input
// float4s. No [positions, 144], [., 80] or [., 40] tensor is written to
// device memory.
// - Forward, a chunk: the keys and q * k into shared memory; h1 and h2 in
//   shared memory; each position's score written to out. After the last
//   chunk, a warp an example takes the max, the sum of exp and the
//   weights over the example's row (zeros where padded).
// - Backward, a chunk: the forward's h1 and h2 recomputed (the same code,
//   so the same bits), the score's gradient from the forward's weights
//   w and the incoming dw, ds_t = w_t (dw_t - sum_valid w dw) * scale;
//   then da2, da1 (the gradients before the sigmoids), the outer products
//   of the parameter gradients (da1 [k, q * k]^T and da2 h1^T) added to
//   the block's accumulators, du = W'^T da1, d_keys = du_k + q * du_qk,
//   and each example's sums of da1 and of k * du_qk. After the last chunk
//   d_query and the query's share of dW1. The accumulators are a block's
//   row of partial sums in shared memory, written once to the scratch; a
//   second kernel sums
//   the rows in a fixed order into the parameter gradients. Each output of
//   either kernel is written by one thread in a fixed order, no atomics:
//   two runs are bit-equal. The padded positions' d_keys are written 0.
// Widths: g in [1, 40], h1 in [1, 80], h2 in [1, 40]: the zoo's 80-40 at
// the widest g whose backward fits the H100's 232,448 bytes of shared
// memory a block at this tiling (219,360 at DIEN's g 36, 231,136 at g 40).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {
namespace da {

// threads of a block: the forward's (two blocks an SM at DIEN's widths;
// 320 give each thread one tile of its first layer there) and the
// backward's (one block an SM: more warps to hide the latency of its
// shared-memory loads)
constexpr int kForwardThreads = 320;
constexpr int kBackwardThreads = 512;
constexpr int kMaxG = 40, kMaxH1 = 80, kMaxH2 = 40;
// examples a block; positions a chunk; a chunk buffer's row stride
constexpr int kE = 32, kP = 64, kS = kP + 4;

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// The widths of a launch.
struct Dims {
  int g, h1, h2, L;
  int gq;      // g rounded up to 4: a row of q
  int m;       // 2g rounded up to 4: a position's operand [k, q * k]
  int n1, n2;  // h1 and h2 rounded up to 4
};

inline Dims make_dims(int g, int h1, int h2, int L) {
  Dims d;
  d.g = g;
  d.h1 = h1;
  d.h2 = h2;
  d.L = L;
  d.gq = up4(g);
  d.m = up4(2 * g);
  d.n1 = up4(h1);
  d.n2 = up4(h2);
  return d;
}

// A block's partial sums of the parameter gradients, in floats: s1
// [n1][m] (the sum of da1 [k, q * k]^T), g2 [n2][n1] (da2 h1^T), qg
// [n1][gq] (the sum over examples of D q^T), db1 [n1], db2 [n2], dw3 [n2],
// db3 [4] (one used).
struct Partial {
  int s1, g2, qg, db1, db2, dw3, db3, total;
};

__host__ __device__ inline Partial partial_layout(const Dims& d) {
  Partial p;
  p.s1 = 0;
  p.g2 = p.s1 + d.n1 * d.m;
  p.qg = p.g2 + d.n2 * d.n1;
  p.db1 = p.qg + d.n1 * d.gq;
  p.db2 = p.db1 + d.n1;
  p.dw3 = p.db2 + d.n2;
  p.db3 = p.dw3 + d.n2;
  p.total = p.db3 + 4;
  return p;
}

// Shared memory, in floats (E, P, S: kE, kP, kS), every array at a
// multiple of 4: w1 [n1][m] (W'), w2 [n2][n1], b2 and w3 [n2], q [E][gq],
// cb [E][n1] (the first layer's offsets), the chunk buffers u [m][S]
// ([k, q * k]), h1 [n1][S],
// h2 [n2][S], the backward's da2 [n2][S], da1 [n1][S], du [m][S] (before
// and after the chunks, W1a + W1c staged there); the backward's dsum
// [E][n1] (D), dq [E][gq] (sum of k * du_qk), cwd [E] (sum of w dw), ds
// [P] and the partial sums; then the ints pe, pt [P] (a chunk position's
// example and t) and pre [E + 1] (the examples' first entries in the
// list). -1: not held.
struct Smem {
  int w1, w2, b2, w3, q, cb, u, h1, h2;
  int da2, da1, du, dsum, dq, cwd, ds, acc;
  int pe, pt, pre, total;
};

__host__ __device__ inline int take(int* o, int n) {
  const int at = *o;
  *o += up4(n);
  return at;
}

__host__ __device__ inline Smem smem_layout(const Dims& d, bool backward) {
  Smem s;
  int o = 0;
  s.w1 = take(&o, d.n1 * d.m);
  s.w2 = take(&o, d.n2 * d.n1);
  s.b2 = take(&o, d.n2);
  s.w3 = take(&o, d.n2);
  s.q = take(&o, kE * d.gq);
  s.cb = take(&o, kE * d.n1);
  s.u = take(&o, d.m * kS);
  s.h1 = take(&o, d.n1 * kS);
  s.h2 = take(&o, d.n2 * kS);
  s.da2 = s.da1 = s.du = s.dsum = s.dq = s.cwd = s.ds = s.acc = -1;
  if (backward) {
    s.da2 = take(&o, d.n2 * kS);
    s.da1 = take(&o, d.n1 * kS);
    s.du = take(&o, d.m * kS);
  }
  // outside the chunk loop the chunk buffers hold W1a + W1c, n1 x g
  if (o - s.u < d.n1 * d.g) o = s.u + up4(d.n1 * d.g);
  if (backward) {
    s.dsum = take(&o, kE * d.n1);
    s.dq = take(&o, kE * d.gq);
    s.cwd = take(&o, kE);
    s.ds = take(&o, kP);
    s.acc = take(&o, partial_layout(d).total);
  }
  s.pe = take(&o, kP);
  s.pt = take(&o, kP);
  s.pre = take(&o, kE + 1);
  s.total = o;
  return s;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float e) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[i][j] = the sum over c < K (a multiple of 4), in order, of
// W[n0 + i][c] X[c][p0 + j]; W's rows ldw floats, X's S.
__device__ __forceinline__ void tile_wx(const float* W, int ldw,
                                        const float* X, int S, int K, int n0,
                                        int p0, float (&acc)[4][4]) {
  zero(acc);
  for (int c = 0; c < K; c += 4) {
    float4 w[4], x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = ld4(W + (n0 + i) * ldw + c);
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ld4(X + (c + r) * S + p0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wv = comp(w[i], r);
        acc[i][0] = fmaf(wv, x[r].x, acc[i][0]);
        acc[i][1] = fmaf(wv, x[r].y, acc[i][1]);
        acc[i][2] = fmaf(wv, x[r].z, acc[i][2]);
        acc[i][3] = fmaf(wv, x[r].w, acc[i][3]);
      }
  }
}

// acc[i][j] = the sum over r < R, in order, of W[r][n0 + i] X[r][p0 + j]
__device__ __forceinline__ void tile_wtx(const float* W, int ldw,
                                         const float* X, int S, int R,
                                         int n0, int p0,
                                         float (&acc)[4][4]) {
  zero(acc);
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const float4 w = ld4(W + r * ldw + n0), x = ld4(X + r * S + p0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float wv = comp(w, i);
      acc[i][0] = fmaf(wv, x.x, acc[i][0]);
      acc[i][1] = fmaf(wv, x.y, acc[i][1]);
      acc[i][2] = fmaf(wv, x.z, acc[i][2]);
      acc[i][3] = fmaf(wv, x.w, acc[i][3]);
    }
  }
}

// acc[i][j] = the sum over p < n (a multiple of 4), in order, of
// A[a0 + i][p] B[b0 + j bs][p]; both with rows of S floats
__device__ __forceinline__ void tile_outer(const float* A, const float* B,
                                           int S, int n, int a0, int b0,
                                           int bs, float (&acc)[4][4]) {
  zero(acc);
  for (int p = 0; p < n; p += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (a0 + i) * S + p);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(B + (b0 + j * bs) * S + p);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = comp(a[i], q);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av, comp(b[j], q), acc[i][j]);
      }
  }
}

// The block's weights, queries and first-layer offsets into shared memory:
// w1 = W' = [W1b - W1c | W1d], w2 = W2, b2, w3 (zeros past the widths), q
// (zeros past the batch) and cb[e][n] = (W1a + W1c) q_e + b1, W1a + W1c
// staged in the chunk buffers as [g][n1].
__device__ void stage(const float* __restrict__ query,
                      const float* __restrict__ w1g,
                      const float* __restrict__ b1g,
                      const float* __restrict__ w2g,
                      const float* __restrict__ b2g,
                      const float* __restrict__ w3g, int64_t b0, int ne,
                      const Dims& d, float* sm, const Smem& lay) {
  const int g = d.g, tid = threadIdx.x;
  float *w1 = sm + lay.w1, *w2 = sm + lay.w2, *q = sm + lay.q;
  float* wq = sm + lay.u;
#pragma unroll 4
  for (int e = tid; e < d.n1 * d.m; e += blockDim.x) {
    const int n = e / d.m, c = e - n * d.m;
    float v = 0.f;
    if (n < d.h1 && c < 2 * g) {
      const float* row = w1g + n * 4 * g;
      v = c < g ? row[g + c] - row[2 * g + c] : row[3 * g + c - g];
    }
    w1[e] = v;
  }
#pragma unroll 4
  for (int e = tid; e < d.n1 * g; e += blockDim.x) {
    const int n = e / g, j = e - n * g;
    const float* row = w1g + n * 4 * g;
    wq[j * d.n1 + n] = n < d.h1 ? row[j] + row[2 * g + j] : 0.f;
  }
#pragma unroll 4
  for (int e = tid; e < d.n2 * d.n1; e += blockDim.x) {
    const int r = e / d.n1, c = e - r * d.n1;
    w2[e] = r < d.h2 && c < d.h1 ? w2g[r * d.h1 + c] : 0.f;
  }
  for (int j = tid; j < d.n2; j += blockDim.x) {
    sm[lay.b2 + j] = j < d.h2 ? b2g[j] : 0.f;
    sm[lay.w3 + j] = j < d.h2 ? w3g[j] : 0.f;
  }
#pragma unroll 4
  for (int e = tid; e < kE * d.gq; e += blockDim.x) {
    const int ex = e / d.gq, j = e - ex * d.gq;
    q[e] = ex < ne && j < g ? query[(b0 + ex) * g + j] : 0.f;
  }
  __syncthreads();
  // an item an (example, n), n fastest
  for (int e = tid; e < kE * d.n1; e += blockDim.x) {
    const int ex = e / d.n1, n = e - ex * d.n1;
    float v = 0.f;
    if (n < d.h1 && ex < ne) {
      float s = 0.f;
#pragma unroll 4
      for (int j = 0; j < g; ++j)
        s = fmaf(wq[j * d.n1 + n], q[ex * d.gq + j], s);
      v = s + b1g[n];
    }
    sm[lay.cb + e] = v;
  }
}

// Each example's valid positions t, in order, into list[(b0 + e) L ...];
// pre[e] the example's first position in the block's order, pre[E] their
// number. With w and dw (the backward), cwd[e] = the sum over the
// example's valid positions of w dw. A warp an example, the mask of 128
// positions loaded at once. Returns the number.
__device__ int compact(const uint8_t* __restrict__ mask, int* list,
                       const float* w, const float* dw, float* cwd,
                       int64_t b0, int ne, const Dims& d, int* pre) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = d.L;
  for (int ex = warp; ex < kE; ex += blockDim.x >> 5) {
    int n = 0;
    float s = 0.f;
    if (ex < ne) {
      const int64_t row = (b0 + ex) * L;
      for (int t0 = 0; t0 < L; t0 += 128) {
        bool v[4];
        float wd[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = t0 + 32 * k + lane;
          v[k] = t < L && mask[row + t];
          wd[k] = cwd != nullptr && v[k] ? w[row + t] * dw[row + t] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned bal = __ballot_sync(0xffffffffu, v[k]);
          if (v[k])
            list[row + n + __popc(bal & ((1u << lane) - 1u))] =
                t0 + 32 * k + lane;
          n += __popc(bal);
          s += wd[k];
        }
      }
    }
    if (cwd != nullptr) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) cwd[ex] = s;
    }
    if (lane == 0) pre[ex + 1] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    pre[0] = 0;
    for (int ex = 0; ex < kE; ++ex) pre[ex + 1] += pre[ex];
  }
  __syncthreads();  // the lists' writes are visible to the whole block
  return pre[kE];
}

// A chunk's positions c0 .. c0 + cnt - 1 of the block's order: pe, pt,
// and u = [k, q * k] for the first pc = cnt rounded up to 4 (zeros past
// cnt)
__device__ void load_chunk(const float* __restrict__ keys, const int* list,
                           int64_t b0, int c0, int cnt, int pc,
                           const Dims& d, float* sm, const Smem& lay) {
  int *pe = reinterpret_cast<int*>(sm + lay.pe);
  int *pt = reinterpret_cast<int*>(sm + lay.pt);
  const int g = d.g, S = kS, tid = threadIdx.x;
  float *u = sm + lay.u, *q = sm + lay.q;
  const int* pre = reinterpret_cast<const int*>(sm + lay.pre);
  for (int p = tid; p < pc; p += blockDim.x) {
    int ex = -1, t = 0;
    if (p < cnt) {  // the example holding entry i: pre[ex] <= i < pre[ex + 1]
      const int i = c0 + p;
      int lo = 0, hi = kE;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (pre[mid] <= i)
          lo = mid;
        else
          hi = mid;
      }
      ex = lo;
      t = list[(b0 + ex) * d.L + i - pre[ex]];
    }
    pe[p] = ex;
    pt[p] = t;
  }
  __syncthreads();
#pragma unroll 4
  for (int e = tid; e < pc * g; e += blockDim.x) {
    const int p = e / g, j = e - p * g;
    float k = 0.f, qk = 0.f;
    if (p < cnt) {
      const int ex = pe[p];
      k = keys[((b0 + ex) * d.L + pt[p]) * g + j];
      qk = q[ex * d.gq + j] * k;
    }
    u[j * S + p] = k;
    u[(g + j) * S + p] = qk;
  }
  for (int e = tid; e < (d.m - 2 * g) * pc; e += blockDim.x) {
    const int r = e / pc;
    u[(2 * g + r) * S + e - r * pc] = 0.f;
  }
}

// h1[n][p] = sigmoid(W' u_p + cb[example of p]) (0 past h1)
__device__ void layer1(const Dims& d, int pc, float* sm, const Smem& lay) {
  const int* pe = reinterpret_cast<const int*>(sm + lay.pe);
  const float *w1 = sm + lay.w1, *u = sm + lay.u, *cb = sm + lay.cb;
  float* h1 = sm + lay.h1;
  const int pq_n = pc / 4, items = pq_n * (d.n1 / 4);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int pq = it % pq_n, n0 = 4 * (it / pq_n), p0 = 4 * pq;
    float acc[4][4];
    tile_wx(w1, d.m, u, kS, d.m, n0, p0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + i;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ex = pe[p0 + j];
        v[j] = n < d.h1
                   ? sigmoid(acc[i][j] + (ex >= 0 ? cb[ex * d.n1 + n] : 0.f))
                   : 0.f;
      }
      st4(h1 + n * kS + p0, v[0], v[1], v[2], v[3]);
    }
  }
}

// h2[n][p] = sigmoid(W2 h1_p + b2) (0 past h2); with kBackward also
// da2[n][p] = ds_p w3[n] (1 - h2) h2, the gradient before the sigmoid
template <bool kBackward>
__device__ void layer2(const Dims& d, int pc, float* sm, const Smem& lay) {
  const float *w2 = sm + lay.w2, *h1 = sm + lay.h1, *b2 = sm + lay.b2;
  const float *w3 = sm + lay.w3, *ds = kBackward ? sm + lay.ds : nullptr;
  float *h2 = sm + lay.h2, *da2 = kBackward ? sm + lay.da2 : nullptr;
  const int pq_n = pc / 4, items = pq_n * (d.n2 / 4);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int pq = it % pq_n, n0 = 4 * (it / pq_n), p0 = 4 * pq;
    float acc[4][4];
    tile_wx(w2, d.n1, h1, kS, d.n1, n0, p0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + i;
      float v[4], a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = n < d.h2 ? sigmoid(acc[i][j] + b2[n]) : 0.f;
        if (kBackward) a[j] = ds[p0 + j] * w3[n] * (1.f - v[j]) * v[j];
      }
      st4(h2 + n * kS + p0, v[0], v[1], v[2], v[3]);
      if (kBackward) st4(da2 + n * kS + p0, a[0], a[1], a[2], a[3]);
    }
  }
}

__global__ void __launch_bounds__(kForwardThreads, 2)
    din_attention_forward_kernel(
        const float* __restrict__ query, const float* __restrict__ keys,
        const uint8_t* __restrict__ mask, const float* __restrict__ w1g,
        const float* __restrict__ b1g, const float* __restrict__ w2g,
        const float* __restrict__ b2g, const float* __restrict__ w3g,
        const float* __restrict__ b3g, float scale, float* out, int* list,
        int64_t n_rows, Dims d) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Smem lay = smem_layout(d, false);
  const int* pe = reinterpret_cast<const int*>(sm + lay.pe);
  const int* pt = reinterpret_cast<const int*>(sm + lay.pt);
  const int64_t b0 = (int64_t)blockIdx.x * kE;
  const int ne = (int)(n_rows - b0 < kE ? n_rows - b0 : kE);
  const int tid = threadIdx.x, L = d.L;

  stage(query, w1g, b1g, w2g, b2g, w3g, b0, ne, d, sm, lay);
  const int total = compact(mask, list, nullptr, nullptr, nullptr, b0, ne,
                            d, reinterpret_cast<int*>(sm + lay.pre));
  const float b3 = b3g[0];
  for (int c0 = 0; c0 < total; c0 += kP) {
    const int cnt = total - c0 < kP ? total - c0 : kP, pc = up4(cnt);
    load_chunk(keys, list, b0, c0, cnt, pc, d, sm, lay);
    __syncthreads();
    layer1(d, pc, sm, lay);
    __syncthreads();
    layer2<false>(d, pc, sm, lay);
    __syncthreads();
    // the scores: w3 . h2 + b3, times scale
    const float *h2 = sm + lay.h2, *w3 = sm + lay.w3;
    for (int p = tid; p < cnt; p += blockDim.x) {
      float s = 0.f;
      for (int n = 0; n < d.h2; ++n) s = fmaf(w3[n], h2[n * kS + p], s);
      out[(b0 + pe[p]) * L + pt[p]] = (s + b3) * scale;
    }
    __syncthreads();
  }

  // a warp an example: the softmax over its valid positions, in place
  const int lane = tid & 31, warp = tid >> 5;
  const int* pre = reinterpret_cast<const int*>(sm + lay.pre);
  for (int ex = warp; ex < ne; ex += blockDim.x >> 5) {
    float* row = out + (b0 + ex) * L;
    const uint8_t* mrow = mask + (b0 + ex) * L;
    if (pre[ex + 1] == pre[ex]) {
      for (int t = lane; t < L; t += 32) row[t] = 0.f;
      continue;
    }
    float mx = __int_as_float(0xff800000);  // -inf
    for (int t = lane; t < L; t += 32)
      if (mrow[t]) mx = fmaxf(mx, row[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int t = lane; t < L; t += 32)
      if (mrow[t]) sum += expf(row[t] - mx);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int t = lane; t < L; t += 32)
      row[t] = mrow[t] ? expf(row[t] - mx) / sum : 0.f;
  }
}

__global__ void __launch_bounds__(kBackwardThreads, 1)
    din_attention_backward_kernel(
        const float* __restrict__ query, const float* __restrict__ keys,
        const uint8_t* __restrict__ mask, const float* __restrict__ w1g,
        const float* __restrict__ b1g, const float* __restrict__ w2g,
        const float* __restrict__ b2g, const float* __restrict__ w3g,
        const float* __restrict__ wts, const float* __restrict__ dwts,
        float scale, float* __restrict__ d_query, float* __restrict__ d_keys,
        float* partials, int* list, int64_t n_rows, Dims d) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Smem lay = smem_layout(d, true);
  const Partial pl = partial_layout(d);
  const int* pe = reinterpret_cast<const int*>(sm + lay.pe);
  const int* pt = reinterpret_cast<const int*>(sm + lay.pt);
  const int64_t b0 = (int64_t)blockIdx.x * kE;
  const int ne = (int)(n_rows - b0 < kE ? n_rows - b0 : kE);
  const int tid = threadIdx.x, L = d.L, g = d.g, S = kS;
  float* acc = sm + lay.acc;
  float *u = sm + lay.u, *h1 = sm + lay.h1, *h2 = sm + lay.h2;
  float *da2 = sm + lay.da2, *da1 = sm + lay.da1, *du = sm + lay.du;
  float *dsum = sm + lay.dsum, *dq = sm + lay.dq, *cwd = sm + lay.cwd;
  float *ds = sm + lay.ds, *q = sm + lay.q;

  for (int e = tid; e < pl.total; e += blockDim.x) acc[e] = 0.f;
  for (int e = tid; e < kE * d.n1; e += blockDim.x) dsum[e] = 0.f;
  for (int e = tid; e < kE * d.gq; e += blockDim.x) dq[e] = 0.f;
  stage(query, w1g, b1g, w2g, b2g, w3g, b0, ne, d, sm, lay);
  const int total = compact(mask, list, wts, dwts, cwd, b0, ne, d,
                            reinterpret_cast<int*>(sm + lay.pre));
  // the padded positions' key gradients: zeros; a warp reads the mask of
  // 32 positions at once, then writes each padded one's row
  {
    const int lane = tid & 31, warp = tid >> 5;
    for (int base = 32 * warp; base < ne * L; base += blockDim.x) {
      const int pos = base + lane;
      unsigned pad =
          __ballot_sync(0xffffffffu, pos < ne * L && !mask[b0 * L + pos]);
      while (pad != 0u) {
        const int64_t row = (b0 * L + base + __ffs(pad) - 1) * g;
        pad &= pad - 1u;
        for (int j = lane; j < g; j += 32) d_keys[row + j] = 0.f;
      }
    }
  }

  const int m4 = d.m / 4, n14 = d.n1 / 4, n24 = d.n2 / 4;
  for (int c0 = 0; c0 < total; c0 += kP) {
    const int cnt = total - c0 < kP ? total - c0 : kP, pc = up4(cnt);
    const int pq_n = pc / 4;
    load_chunk(keys, list, b0, c0, cnt, pc, d, sm, lay);
    __syncthreads();
    for (int p = tid; p < pc; p += blockDim.x) {
      float v = 0.f;
      if (p < cnt) {
        const int ex = pe[p];
        const int64_t at = (b0 + ex) * L + pt[p];
        v = wts[at] * (dwts[at] - cwd[ex]) * scale;
      }
      ds[p] = v;
    }
    layer1(d, pc, sm, lay);
    __syncthreads();
    layer2<true>(d, pc, sm, lay);
    __syncthreads();
    // da1 = (W2^T da2) (1 - h1) h1
    for (int it = tid; it < pq_n * n14; it += blockDim.x) {
      const int p0 = 4 * (it % pq_n), n0 = 4 * (it / pq_n);
      float a[4][4];
      tile_wtx(sm + lay.w2, d.n1, da2, S, d.n2, n0, p0, a);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 h = ld4(h1 + (n0 + i) * S + p0);
        st4(da1 + (n0 + i) * S + p0, a[i][0] * (1.f - h.x) * h.x,
            a[i][1] * (1.f - h.y) * h.y, a[i][2] * (1.f - h.z) * h.z,
            a[i][3] * (1.f - h.w) * h.w);
      }
    }
    __syncthreads();

    // every product of the chunk that reads da1 or da2, as one list of
    // work items: the outer products into the accumulators, du = W'^T da1,
    // then the sums of db2, dw3, db3 and each example's D
    const int n_g1 = n14 * m4, n_g2 = n24 * n14, n_du = pq_n * m4;
    const int n_work = n_g1 + n_g2 + n_du + d.n2 + 1 + d.n1;
    for (int w = tid; w < n_work; w += blockDim.x) {
      float a[4][4];
      if (w < n_g1) {  // s1 += da1 u^T
        const int bq = w % m4, a0 = 4 * (w / m4);
        tile_outer(da1, u, S, pc, a0, bq, m4, a);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[pl.s1 + (a0 + i) * d.m + bq + j * m4] += a[i][j];
        continue;
      }
      int r = w - n_g1;
      if (r < n_g2) {  // g2 += da2 h1^T
        const int bq = r % n14, a0 = 4 * (r / n14);
        tile_outer(da2, h1, S, pc, a0, bq, n14, a);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[pl.g2 + (a0 + i) * d.n1 + bq + j * n14] += a[i][j];
        continue;
      }
      r -= n_g2;
      if (r < n_du) {  // du = W'^T da1
        const int p0 = 4 * (r % pq_n), c0_ = 4 * (r / pq_n);
        tile_wtx(sm + lay.w1, d.m, da1, S, d.n1, c0_, p0, a);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st4(du + (c0_ + i) * S + p0, a[i][0], a[i][1], a[i][2], a[i][3]);
        continue;
      }
      r -= n_du;
      if (r < d.n2) {  // db2, dw3
        float sb = 0.f, sw = 0.f;
        for (int p = 0; p < cnt; ++p) {
          sb += da2[r * S + p];
          sw = fmaf(ds[p], h2[r * S + p], sw);
        }
        acc[pl.db2 + r] += sb;
        acc[pl.dw3 + r] += sw;
        continue;
      }
      r -= d.n2;
      if (r == 0) {  // db3
        float s = 0.f;
        for (int p = 0; p < cnt; ++p) s += ds[p];
        acc[pl.db3] += s;
        continue;
      }
      const int n = r - 1;  // D[e][n], a run of an example at a time
      int cur = pe[0];
      float run = 0.f;
      for (int p = 0; p < cnt; ++p) {
        if (pe[p] != cur) {
          dsum[cur * d.n1 + n] += run;
          run = 0.f;
          cur = pe[p];
        }
        run += da1[n * S + p];
      }
      dsum[cur * d.n1 + n] += run;
    }
    __syncthreads();

    // d_keys = du_k + q du_qk; each example's sum of k du_qk
    for (int e = tid; e < cnt * g + g; e += blockDim.x) {
      if (e < cnt * g) {
        const int p = e / g, j = e - p * g, ex = pe[p];
        d_keys[((b0 + ex) * L + pt[p]) * g + j] =
            du[j * S + p] + q[ex * d.gq + j] * du[(g + j) * S + p];
        continue;
      }
      const int j = e - cnt * g;
      int cur = pe[0];
      float run = 0.f;
      for (int p = 0; p < cnt; ++p) {
        if (pe[p] != cur) {
          dq[cur * d.gq + j] += run;
          run = 0.f;
          cur = pe[p];
        }
        run = fmaf(u[j * S + p], du[(g + j) * S + p], run);
      }
      dq[cur * d.gq + j] += run;
    }
    __syncthreads();
  }

  // d_query = (W1a + W1c)^T D + the sum of k du_qk, W1a + W1c staged in
  // the chunk buffers as [h1][g]; an item an (example, j), j fastest
  float* wq = u;
#pragma unroll 4
  for (int e = tid; e < d.h1 * g; e += blockDim.x) {
    const int n = e / g, j = e - n * g;
    wq[e] = w1g[n * 4 * g + j] + w1g[n * 4 * g + 2 * g + j];
  }
  __syncthreads();
  for (int e = tid; e < ne * g; e += blockDim.x) {
    const int ex = e / g, j = e - ex * g;
    float s = 0.f;
#pragma unroll 4
    for (int n = 0; n < d.h1; ++n)
      s = fmaf(wq[n * g + j], dsum[ex * d.n1 + n], s);
    d_query[(b0 + ex) * g + j] = dq[ex * d.gq + j] + s;
  }
  // the query's share of dW1: qg = sum over examples of D q^T; db1 = the
  // sum of D
  for (int e = tid; e < d.n1 * d.gq; e += blockDim.x) {
    const int n = e / d.gq, j = e - n * d.gq;
    float s = 0.f;
    for (int ex = 0; ex < ne; ++ex)
      s = fmaf(dsum[ex * d.n1 + n], q[ex * d.gq + j], s);
    acc[pl.qg + e] = s;
  }
  for (int n = tid; n < d.n1; n += blockDim.x) {
    float s = 0.f;
    for (int ex = 0; ex < ne; ++ex) s += dsum[ex * d.n1 + n];
    acc[pl.db1 + n] = s;
  }
  __syncthreads();
  float* row_out = partials + (int64_t)blockIdx.x * pl.total;
  for (int e = tid; e < pl.total; e += blockDim.x) row_out[e] = acc[e];
}

// The parameter gradients from the blocks' partial rows [rows][np], each
// summed over the rows in order: a block takes 32 outputs, its 8 warps a
// contiguous eighth of the rows each, the eighths added in order. Output
// (flat): dW1 [h1][4g], db1 [h1], dW2 [h2][h1], db2 [h2], dw3 [h2], db3.
constexpr int kReduceGroups = 8;

__global__ void __launch_bounds__(32 * kReduceGroups)
    din_attention_reduce_kernel(const float* __restrict__ partials,
                                int rows, Dims d, float* __restrict__ out,
                                int n_out) {
  __shared__ float sums[2][kReduceGroups][32];
  const Partial pl = partial_layout(d);
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + lane, g = d.g;
  // the output's column, and for dW1c the column it subtracts
  int plus = -1, minus = -1;
  if (o < n_out) {
    int r = o;
    if (r < d.h1 * 4 * g) {
      const int n = r / (4 * g), c = r - n * 4 * g, part = c / g;
      const int j = c - part * g;
      const int qg = pl.qg + n * d.gq + j, s1 = pl.s1 + n * d.m + j;
      plus = part == 0 || part == 2 ? qg : part == 1 ? s1 : s1 + g;
      if (part == 2) minus = s1;
    } else if ((r -= d.h1 * 4 * g) < d.h1) {
      plus = pl.db1 + r;
    } else if ((r -= d.h1) < d.h2 * d.h1) {
      const int u2 = r / d.h1;
      plus = pl.g2 + u2 * d.n1 + r - u2 * d.h1;
    } else if ((r -= d.h2 * d.h1) < d.h2) {
      plus = pl.db2 + r;
    } else if ((r -= d.h2) < d.h2) {
      plus = pl.dw3 + r;
    } else {
      plus = pl.db3;
    }
  }
  const int lo = (int)((int64_t)rows * grp / kReduceGroups);
  const int hi = (int)((int64_t)rows * (grp + 1) / kReduceGroups);
  float a = 0.f, b = 0.f;
  if (plus >= 0)
    for (int r = lo; r < hi; ++r) a += partials[(int64_t)r * pl.total + plus];
  if (minus >= 0)
    for (int r = lo; r < hi; ++r) b += partials[(int64_t)r * pl.total + minus];
  sums[0][grp][lane] = a;
  sums[1][grp][lane] = b;
  __syncthreads();
  if (grp == 0 && o < n_out) {
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < kReduceGroups; ++k) {
      sa += sums[0][k][lane];
      sb += sums[1][k][lane];
    }
    out[o] = minus >= 0 ? sa - sb : sa;
  }
}

bool widths_ok(int64_t n_rows, int L, int g, int h1, int h2) {
  return n_rows > 0 && L > 0 && g >= 1 && g <= kMaxG && h1 >= 1 &&
         h1 <= kMaxH1 && h2 >= 1 && h2 <= kMaxH2 &&
         (int64_t)L * kE * kMaxG < (int64_t)1 << 31;
}

int64_t blocks(int64_t n_rows) { return (n_rows + kE - 1) / kE; }

// Bytes of the scratch: the list (an int a position), then for the
// backward the blocks' partial rows, each at a multiple of 256 bytes.
int64_t scratch_bytes(int64_t n_rows, const Dims& d, bool backward) {
  const int64_t list = (n_rows * d.L * 4 + 255) / 256 * 256;
  if (!backward) return list;
  return list + blocks(n_rows) * partial_layout(d).total * 4;
}

}  // namespace da
}  // namespace

// Bytes of scratch that deeprec_din_attention (backward 0) or its
// backward (1) take at these widths; 0 where the widths are out of range.
extern "C" int64_t deeprec_din_attention_scratch(int64_t n_rows, int L,
                                                 int g, int h1, int h2,
                                                 int backward) {
  if (!da::widths_ok(n_rows, L, g, h1, h2)) return 0;
  return da::scratch_bytes(n_rows, da::make_dims(g, h1, h2, L),
                           backward != 0);
}

// The forward of n_rows examples: query f32 [n_rows, g], keys f32 [n_rows,
// L, g], mask bool [n_rows, L], w1 [h1, 4g], b1 [h1], w2 [h2, h1], b2
// [h2], w3 [1, h2], b3 [1] (nn.Linear's layout), all contiguous; scale
// multiplies the scores. Writes out f32 [n_rows, L], the attention
// weights (0 at padded positions). scratch: deeprec_din_attention_scratch
// bytes (backward 0). g in [1, 40], h1 in [1, 80], h2 in [1, 40], n_rows
// and L above 0, else cudaErrorInvalidValue unlaunched. Returns the
// launch's cudaError_t; 0 is success. Never syncs.
extern "C" int deeprec_din_attention(
    const void* query, const void* keys, const void* mask, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* w3,
    const void* b3, float scale, void* out, void* scratch, int64_t n_rows,
    int L, int g, int h1, int h2, void* stream) {
  if (!da::widths_ok(n_rows, L, g, h1, h2))
    return (int)cudaErrorInvalidValue;
  const da::Dims d = da::make_dims(g, h1, h2, L);
  const int64_t smem = (int64_t)da::smem_layout(d, false).total * 4;
  cudaError_t err = allow_smem(da::din_attention_forward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  da::din_attention_forward_kernel<<<(unsigned)da::blocks(n_rows),
                                     da::kForwardThreads, smem,
                                     (cudaStream_t)stream>>>(
      (const float*)query, (const float*)keys, (const uint8_t*)mask,
      (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (const float*)w3, (const float*)b3, scale,
      (float*)out, (int*)scratch, n_rows, d);
  return (int)cudaGetLastError();
}

// The backward of deeprec_din_attention's call on the same inputs, weights
// its output and grad f32 [n_rows, L] the output's gradient. Writes
// d_query [n_rows, g], d_keys [n_rows, L, g] (0 at padded positions) and
// d_params, flat: dW1 [h1, 4g], db1 [h1], dW2 [h2, h1], db2 [h2], dw3
// [h2], db3 [1]. scratch: deeprec_din_attention_scratch bytes (backward
// 1). Two kernels, one after the other on stream.
extern "C" int deeprec_din_attention_backward(
    const void* query, const void* keys, const void* mask, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* w3,
    const void* weights, const void* grad, float scale, void* d_query,
    void* d_keys, void* d_params, void* scratch, int64_t n_rows, int L,
    int g, int h1, int h2, void* stream) {
  if (!da::widths_ok(n_rows, L, g, h1, h2))
    return (int)cudaErrorInvalidValue;
  const da::Dims d = da::make_dims(g, h1, h2, L);
  const int64_t smem = (int64_t)da::smem_layout(d, true).total * 4;
  cudaError_t err = allow_smem(da::din_attention_backward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t blocks = da::blocks(n_rows);
  float* partials =
      (float*)((char*)scratch + da::scratch_bytes(n_rows, d, false));
  da::din_attention_backward_kernel<<<(unsigned)blocks,
                                      da::kBackwardThreads, smem, st>>>(
      (const float*)query, (const float*)keys, (const uint8_t*)mask,
      (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (const float*)w3, (const float*)weights,
      (const float*)grad, scale, (float*)d_query, (float*)d_keys, partials,
      (int*)scratch, n_rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = 4 * g * h1 + h1 + h2 * h1 + 2 * h2 + 1;
  da::din_attention_reduce_kernel<<<(n_out + 31) / 32,
                                    32 * da::kReduceGroups, 0, st>>>(
      partials, (int)blocks, d, (float*)d_params, n_out);
  return (int)cudaGetLastError();
}
