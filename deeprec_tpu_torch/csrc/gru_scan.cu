// DIEN's GRU and AUGRU recurrences (models/layers.py GRU, AUGRU), forward
// and backward. For a row b of xs [B, L, d] (f32, contiguous), from h = 0,
// at each step t where mask[b, t] holds (else h is held):
//   z, r = sigmoid(W_g [x_t, h] + b_g)      W_g [2g, d + g], nn.Linear's
//   n    = tanh(W_c [x_t, r * h] + b_c)     W_c [g, d + g]
//   z   *= att[b, t]                        (AUGRU only)
//   h    = (1 - z) h + z n
// The GRU writes every state [B, L, g] (a padded step writes the held
// state); the AUGRU writes its last state [B, g].
//
// Replaces no TPU kernel: the JAX package's GRU and AUGRU are nn.scan loops
// that XLA compiles. In PyTorch the loop is some 25 launches a cell step
// each way, 200 cell steps a DIEN step at history 100, and the backward of
// each step's slice xs[:, t] zero-fills and adds a whole [B, L, d] gradient:
// about 100 ms a step at B 16,384 on an H100, against the 3.5 GFLOP of the
// two recurrences' valid positions.
//
// What bounds it: the sequence. A row's steps run one after another, each a
// [d + g] x [3g] product a row, so the FLOPs a byte are many (7,776 FMAs
// per 144 bytes of x at d = g = 36) but the chain of 100 steps sets the
// latency of the longest rows. Every position, forward and backward, is
// 150 GFLOP, 2.3 ms at the f32 FMA peak; the valid ones (13.8 % of them in
// the DIEN cell) a seventh of that. f32 FMAs on CUDA cores: no tensor
// cores, no TF32 (the benchmark's TF32 control fails its limits).
//
// Design: a block owns a tile of kRows rows and loops over t inside, its
// h on chip the whole time; rows are independent, so blocks never meet.
// The weights, (d + g) x 3g floats (31 KB at DIEN's widths), are staged in
// shared memory once a block: transposed for the forward (a thread's unit
// is a column, consecutive threads read consecutive floats), as given for
// the backward (there a thread's output is a column of W^T). A thread
// carries kGroup rows of one unit: each shared-memory weight feeds kGroup
// FMAs and the kGroup inputs are one float4 that every thread of the warp
// reads (a broadcast). The wrapper (ops/recurrence.py) sorts the rows by
// their span (the last valid step + 1), longest first, so a tile holds rows
// of about one length, stops after its longest row's span and the longest
// tiles start first; past the span it only writes the held state (forward)
// or zeros (backward). A padded step inside the span holds h, so any mask
// stays exact. The next step's inputs are copied to shared memory
// (cp.async) while the current step computes.
// - Forward, a step: (1) the gates' units over [x, h] and the candidate's
//   units over x; sigmoid; z (scaled by att) and r * h into shared memory;
//   (2) the candidate's units go on over r * h; tanh; h updated in place.
//   In training it also writes u = sigmoid(.) of z, r and n of each valid
//   position into gates [B, L, 3g] (read back by the backward: 432 bytes a
//   valid position at g 36, none written at padded ones).
// - Backward, t from the span down to 0, dh carried on chip: (A) a unit's
//   elementwise part: dpz, dpn into shared memory and the direct (1 - z) dh;
//   (B) dc = W_c^T dpn: its h half gives dr, so dpr, and r * dc; (C) da =
//   W_g^T [dpz, dpr]: dx = dc_x + da_x, and the carried dh of step t - 1.
//   It reads h_{t-1} from the states and the gates from the forward's
//   buffer, and writes each position's pre-activation gradients d_pre [B,
//   L, 3g] and act [B, L, W] = [x_t, h_{t-1}, r h_{t-1}, 1, 0...] (W a
//   multiple of 4; zero at padded positions), so that the weight and bias
//   gradients are one matrix product d_pre^T act over all B L positions
//   outside the kernel; dx, and the AUGRU's d_att[b, t] = sum_j dz_j u_j,
//   summed by one thread a row in unit order. No atomics: two runs are
//   bit-equal.
// Widths d, g in [1, kMaxWidth]; the launch's threads and shared memory
// follow them (at most 768 threads; 172 KB at the widest).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {
namespace gs {

constexpr int kRows = 16;   // rows of a tile, one tile a block
constexpr int kGroup = 4;   // rows a thread carries: one float4
constexpr int kGroups = kRows / kGroup;
constexpr int kMaxWidth = 64;

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// Threads of a launch: one a (unit, row group) item, in whole warps.
__host__ __device__ constexpr int threads(int units) {
  return (units * kGroups + 31) / 32 * 32;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float w, float4 a, float* acc) {
  acc[0] = fmaf(w, a.x, acc[0]);
  acc[1] = fmaf(w, a.y, acc[1]);
  acc[2] = fmaf(w, a.z, acc[2]);
  acc[3] = fmaf(w, a.w, acc[3]);
}

// Shared memory of the forward, in floats, every array at a multiple of 4:
//   w [K][N] W^T (N = 3g units: z, r, then n), bias [N], in [K][kRows]
//   (x_t^T, then h^T), rh [g][kRows] (r h)^T, z [g][kRows], stage
//   [2][kRows][d] (x of this step and the next), valid and att [2][kRows].
struct FwdLayout {
  int w, bias, in, rh, z, stage, valid, att, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int d, int g) {
  const int k = d + g, n = 3 * g;
  FwdLayout s;
  s.w = 0;
  s.bias = up4(k * n);
  s.in = s.bias + up4(n);
  s.rh = s.in + k * kRows;
  s.z = s.rh + g * kRows;
  s.stage = s.z + g * kRows;
  s.valid = s.stage + up4(2 * kRows * d);
  s.att = s.valid + 2 * kRows;
  s.total = s.att + 2 * kRows;
  return s;
}

// Shared memory of the backward, in floats: w [N][K] (W_g then W_c, as
// given), dp [N][kRows] (dpz, dpr, dpn)^T, carry, direct and datt
// [g][kRows], stage [2][kRows][S] (a row's h_{t-1}, u, r, n, for the GRU
// the output's gradient at t, and x_t: stage_row), valid and att
// [2][kRows].
struct BwdLayout {
  int w, dp, carry, direct, datt, stage, valid, att, total;
};

__host__ __device__ constexpr int stage_row(int d, int g, bool att) {
  return 4 * g + (att ? 0 : g) + d;
}

// A row of the weight gradients' operand act [B, L, W]: x, h_{t-1},
// r h_{t-1}, a one (the biases' column), zeros to a multiple of 4.
__host__ __device__ constexpr int act_width(int d, int g) {
  return up4(d + 2 * g + 1);
}

__host__ __device__ inline BwdLayout bwd_layout(int d, int g, int s_row) {
  const int k = d + g, n = 3 * g;
  BwdLayout s;
  s.w = 0;
  s.dp = up4(n * k);
  s.carry = s.dp + n * kRows;
  s.direct = s.carry + g * kRows;
  s.datt = s.direct + g * kRows;
  s.stage = s.datt + g * kRows;
  s.valid = s.stage + up4(2 * kRows * s_row);
  s.att = s.valid + 2 * kRows;
  s.total = s.att + 2 * kRows;
  return s;
}

// The tile's rows (-1 past the batch) and its span: the largest of its
// rows' spans.
__device__ __forceinline__ int tile_rows(const int64_t* __restrict__ order,
                                         const int64_t* __restrict__ span,
                                         int64_t n_rows, int64_t* rows,
                                         int* t_end) {
  if (threadIdx.x < kRows) {
    const int64_t i = (int64_t)blockIdx.x * kRows + threadIdx.x;
    rows[threadIdx.x] = i < n_rows ? order[i] : -1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int64_t m = 0;
    for (int r = 0; r < kRows; ++r)
      if (rows[r] >= 0 && span[rows[r]] > m) m = span[rows[r]];
    *t_end = (int)m;
  }
  __syncthreads();
  return *t_end;
}

// mask[b, t] and att[b, t] of the thread's row (threads < kRows).
template <bool kAtt>
__device__ __forceinline__ void step_flags(const uint8_t* __restrict__ mask,
                                           const float* __restrict__ att,
                                           int64_t b, int t, int L,
                                           float* valid, float* a) {
  *valid = b >= 0 && mask[b * L + t] ? 1.f : 0.f;
  *a = kAtt && b >= 0 ? att[b * L + t] : 1.f;
}

template <bool kAtt>
__global__ void gru_scan_forward_kernel(
    const float* __restrict__ xs, const uint8_t* __restrict__ mask,
    const float* __restrict__ att, const float* __restrict__ wg,
    const float* __restrict__ bg, const float* __restrict__ wc,
    const float* __restrict__ bc, const int64_t* __restrict__ order,
    const int64_t* __restrict__ span, float* __restrict__ hs,
    float* __restrict__ last, float* __restrict__ gates, int64_t n_rows,
    int L, int d, int g) {
  extern __shared__ float4 smem4[];
  __shared__ int64_t rows[kRows];
  __shared__ int t_end_s;
  float* sm = reinterpret_cast<float*>(smem4);
  const FwdLayout lay = fwd_layout(d, g);
  float *w = sm + lay.w, *bias = sm + lay.bias, *in = sm + lay.in;
  float *rh = sm + lay.rh, *zs = sm + lay.z, *stage = sm + lay.stage;
  float *valid = sm + lay.valid, *atts = sm + lay.att;
  const int K = d + g, N = 3 * g, tid = threadIdx.x, T = blockDim.x;

  for (int e = tid; e < N * K; e += T) {  // [W_g; W_c] row-major, coalesced
    const int j = e / K, k = e - j * K;
    w[k * N + j] = j < 2 * g ? wg[e] : wc[e - 2 * g * K];
  }
  for (int j = tid; j < N; j += T) bias[j] = j < 2 * g ? bg[j] : bc[j - 2 * g];
  for (int e = tid; e < g * kRows; e += T) in[d * kRows + e] = 0.f;
  const int t_end = tile_rows(order, span, n_rows, rows, &t_end_s);

  // x of step t of the tile's rows into stage buffer t & 1
  auto stage_x = [&](int t) {
    float* s = stage + (t & 1) * kRows * d;
    for (int e = tid; e < kRows * d; e += T) {
      const int r = e / d, k = e - r * d;
      if (rows[r] >= 0) copy_async(s + e, xs + (rows[r] * L + t) * d + k);
    }
    commit_async();
  };
  float v_next = 0.f, a_next = 1.f;
  if (t_end > 0) {
    stage_x(0);
    if (tid < kRows)
      step_flags<kAtt>(mask, att, rows[tid], 0, L, valid + tid, atts + tid);
  }

  const bool active = tid < N * kGroups;
  const int j = tid % N, q = tid / N;
  const bool gate = j < 2 * g;
  const float bj = active ? bias[j] : 0.f;
  float acc[kGroup];
  for (int t = 0; t < t_end; ++t) {
    const int cur = t & 1;
    const float* vs = valid + cur * kRows;
    const float* as = atts + cur * kRows;
    wait_async();
    __syncthreads();  // x_t landed; last step's h, flags and reads done
    if (t + 1 < t_end) {
      stage_x(t + 1);
      if (tid < kRows)
        step_flags<kAtt>(mask, att, rows[tid], t + 1, L, &v_next, &a_next);
    }
    const float* sx = stage + cur * kRows * d;
    for (int e = tid; e < kRows * d; e += T) {
      const int r = e / d, k = e - r * d;
      in[k * kRows + r] = sx[e];
    }
    __syncthreads();

    // (1) z, r over [x, h]; the candidate over x
    if (active) {
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc[i] = 0.f;
      const int k_end = gate ? K : d;
      const float* col = w + j;
      const float* x4 = in + q * kGroup;
      for (int k = 0; k < k_end; ++k)
        fma4(col[k * N], load4(x4 + k * kRows), acc);
      if (gate) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int r = q * kGroup + i;
          const float s = sigmoid(acc[i] + bj);
          if (j < g) {
            zs[j * kRows + r] = kAtt ? as[r] * s : s;
          } else {
            const int u = j - g;
            rh[u * kRows + r] = s * in[(d + u) * kRows + r];
          }
          if (gates != nullptr && vs[r] != 0.f)
            gates[(rows[r] * L + t) * N + j] = s;
        }
      }
    }
    __syncthreads();

    // (2) the candidate over r h; the new state
    if (active && !gate) {
      const int u = j - 2 * g;
      const float* col = w + d * N + j;
      const float* rh4 = rh + q * kGroup;
      for (int k = 0; k < g; ++k)
        fma4(col[k * N], load4(rh4 + k * kRows), acc);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int r = q * kGroup + i;
        const float n = tanhf(acc[i] + bj);
        float* hp = in + (d + u) * kRows + r;
        const float h = *hp, z = zs[u * kRows + r];
        const float hn = vs[r] != 0.f ? (1.f - z) * h + z * n : h;
        *hp = hn;
        const int64_t b = rows[r];
        if (b >= 0) {
          if (gates != nullptr && vs[r] != 0.f) gates[(b * L + t) * N + j] = n;
          if (hs != nullptr) hs[(b * L + t) * g + u] = hn;
        }
      }
    }
    if (tid < kRows) {  // the next step's flags (its buffer is free)
      valid[(cur ^ 1) * kRows + tid] = v_next;
      atts[(cur ^ 1) * kRows + tid] = a_next;
    }
  }
  __syncthreads();

  // past the span: the held state (the GRU's states), and the last state
  for (int e = tid; e < kRows * g; e += T) {
    const int r = e / g, u = e - r * g;
    const int64_t b = rows[r];
    if (b < 0) continue;
    const float h = in[(d + u) * kRows + r];
    if (last != nullptr) last[b * g + u] = h;
    if (!kAtt)
      for (int t = t_end; t < L; ++t) hs[(b * L + t) * g + u] = h;
  }
}

template <bool kAtt>
__global__ void gru_scan_backward_kernel(
    const uint8_t* __restrict__ mask, const float* __restrict__ att,
    const float* __restrict__ wg, const float* __restrict__ wc,
    const int64_t* __restrict__ order, const int64_t* __restrict__ span,
    const float* __restrict__ xs, const float* __restrict__ hs,
    const float* __restrict__ gates, const float* __restrict__ grad,
    float* __restrict__ dx, float* __restrict__ d_pre,
    float* __restrict__ act, float* __restrict__ d_att, int64_t n_rows,
    int L, int d, int g) {
  extern __shared__ float4 smem4[];
  __shared__ int64_t rows[kRows];
  __shared__ int t_end_s;
  float* sm = reinterpret_cast<float*>(smem4);
  const int S = stage_row(d, g, kAtt), xo = S - d, W = act_width(d, g);
  const BwdLayout lay = bwd_layout(d, g, S);
  float *w = sm + lay.w, *dp = sm + lay.dp, *carry = sm + lay.carry;
  float *direct = sm + lay.direct, *datt = sm + lay.datt;
  float *stage = sm + lay.stage, *valid = sm + lay.valid;
  float* atts = sm + lay.att;
  const int K = d + g, N = 3 * g, tid = threadIdx.x, T = blockDim.x;

  for (int e = tid; e < N * K; e += T)
    w[e] = e < 2 * g * K ? wg[e] : wc[e - 2 * g * K];
  const int t_end = tile_rows(order, span, n_rows, rows, &t_end_s);

  // dh flowing into the span's last step: the GRU's output gradients past
  // the span (the held state is each of those outputs), from the last
  // backwards; the AUGRU's last state's gradient
  for (int e = tid; e < kRows * g; e += T) {
    const int r = e / g, u = e - r * g;
    const int64_t b = rows[r];
    float c = 0.f;
    if (b >= 0) {
      if (kAtt)
        c = grad[b * g + u];
      else
        for (int t = L - 1; t >= t_end; --t) c += grad[(b * L + t) * g + u];
    }
    carry[u * kRows + r] = c;
  }
  // past the span every gradient is zero
  const int64_t tail = L - t_end;
  for (int r = 0; r < kRows; ++r) {
    const int64_t b = rows[r];
    if (b < 0) continue;
    const int64_t p = b * L + t_end;
    for (int64_t e = tid; e < tail * d; e += T) dx[p * d + e] = 0.f;
    for (int64_t e = tid; e < tail * N; e += T) d_pre[p * N + e] = 0.f;
    for (int64_t e = tid; e < tail * W; e += T) act[p * W + e] = 0.f;
    if (kAtt)
      for (int64_t e = tid; e < tail; e += T) d_att[p + e] = 0.f;
  }

  // h_{t-1}, the gates at t, (GRU) the output's gradient at t and x_t into
  // stage buffer t & 1
  auto stage_step = [&](int t) {
    float* s = stage + (t & 1) * kRows * S;
    for (int e = tid; e < kRows * S; e += T) {
      const int r = e / S, c = e - r * S;
      const int64_t b = rows[r];
      if (b < 0) continue;
      const int64_t p = b * L + t;
      if (c < g) {
        if (t > 0) copy_async(s + e, hs + (p - 1) * g + c);
      } else if (c < 4 * g) {
        copy_async(s + e, gates + p * N + c - g);
      } else if (c < xo) {
        copy_async(s + e, grad + p * g + c - 4 * g);
      } else {
        copy_async(s + e, xs + p * d + c - xo);
      }
    }
    commit_async();
  };
  float v_next = 0.f, a_next = 1.f;
  if (t_end > 0) {
    stage_step(t_end - 1);
    if (tid < kRows)
      step_flags<kAtt>(mask, att, rows[tid], t_end - 1, L,
                       valid + ((t_end - 1) & 1) * kRows + tid,
                       atts + ((t_end - 1) & 1) * kRows + tid);
  }

  const int qa = tid / g, ua = tid - qa * g;  // phase A: (unit, row group)
  const int qc = tid / K, kc = tid - qc * K;  // phases B, C: (column, group)
  const bool in_a = tid < g * kGroups, in_c = tid < K * kGroups;
  float keep[kGroup];  // dc_x (column < d) or r dc_h (column >= d)
  for (int t = t_end - 1; t >= 0; --t) {
    const int cur = t & 1;
    const float* vs = valid + cur * kRows;
    const float* as = atts + cur * kRows;
    const float* st = stage + cur * kRows * S;
    wait_async();
    __syncthreads();  // step t's inputs landed; step t + 1 done
    if (t > 0) {
      stage_step(t - 1);
      if (tid < kRows)
        step_flags<kAtt>(mask, att, rows[tid], t - 1, L, &v_next, &a_next);
    }

    // (A) a unit's elementwise part
    if (in_a) {
      const int u = ua;
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int r = qa * kGroup + i;
        const float* s = st + r * S;
        const float hp = t > 0 ? s[u] : 0.f;
        const float uz = s[g + u], rr = s[2 * g + u], n = s[3 * g + u];
        const float dh = kAtt ? carry[u * kRows + r]
                              : carry[u * kRows + r] + s[4 * g + u];
        const float a = as[r], z = kAtt ? a * uz : uz;
        const bool v = vs[r] != 0.f;
        const float dz = dh * (n - hp);
        const float dpz = v ? (kAtt ? dz * a : dz) * uz * (1.f - uz) : 0.f;
        const float dpn = v ? dh * z * (1.f - n * n) : 0.f;
        dp[u * kRows + r] = dpz;
        dp[(2 * g + u) * kRows + r] = dpn;
        direct[u * kRows + r] = v ? dh * (1.f - z) : dh;
        if (kAtt) datt[u * kRows + r] = dz * uz;
        const int64_t b = rows[r];
        if (b >= 0) {
          const int64_t p = b * L + t;
          d_pre[p * N + u] = dpz;
          d_pre[p * N + 2 * g + u] = dpn;
          act[p * W + d + u] = v ? hp : 0.f;
          act[p * W + d + g + u] = v ? rr * hp : 0.f;
        }
      }
    }
    // act's other columns: x_t, the one, the zeros
    for (int e = tid; e < kRows * (W - 2 * g); e += T) {
      const int r = e / (W - 2 * g), c = e - r * (W - 2 * g);
      const int64_t b = rows[r];
      if (b < 0) continue;
      const bool v = vs[r] != 0.f;
      act[(b * L + t) * W + (c < d ? c : c + 2 * g)] =
          !v ? 0.f : c < d ? st[r * S + xo + c] : c == d ? 1.f : 0.f;
    }
    __syncthreads();

    // (B) dc = W_c^T dpn; its h half: dpr and r dc
    if (in_c) {
      float acc[kGroup] = {0.f, 0.f, 0.f, 0.f};
      const float* col = w + 2 * g * K + kc;
      const float* dp4 = dp + 2 * g * kRows + qc * kGroup;
      for (int u = 0; u < g; ++u)
        fma4(col[u * K], load4(dp4 + u * kRows), acc);
      if (kc < d) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) keep[i] = acc[i];
      } else {
        const int u = kc - d;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const int r = qc * kGroup + i;
          const float* s = st + r * S;
          const float hp = t > 0 ? s[u] : 0.f, rr = s[2 * g + u];
          const float dpr =
              vs[r] != 0.f ? acc[i] * hp * rr * (1.f - rr) : 0.f;
          dp[(g + u) * kRows + r] = dpr;
          keep[i] = acc[i] * rr;
          if (rows[r] >= 0) d_pre[(rows[r] * L + t) * N + g + u] = dpr;
        }
      }
    }
    if (kAtt && tid < kRows && rows[tid] >= 0) {  // d_att, in unit order
      float s = 0.f;
      for (int u = 0; u < g; ++u) s += datt[u * kRows + tid];
      d_att[rows[tid] * L + t] = vs[tid] != 0.f ? s : 0.f;
    }
    __syncthreads();

    // (C) da = W_g^T [dpz, dpr]: dx, and the dh carried to step t - 1
    if (in_c) {
      float acc[kGroup] = {0.f, 0.f, 0.f, 0.f};
      const float* col = w + kc;
      const float* dp4 = dp + qc * kGroup;
      for (int j = 0; j < 2 * g; ++j)
        fma4(col[j * K], load4(dp4 + j * kRows), acc);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int r = qc * kGroup + i;
        const bool v = vs[r] != 0.f;
        if (kc < d) {
          if (rows[r] >= 0)
            dx[(rows[r] * L + t) * d + kc] = v ? keep[i] + acc[i] : 0.f;
        } else {
          const int u = kc - d;
          const float dh = direct[u * kRows + r];
          carry[u * kRows + r] = v ? dh + keep[i] + acc[i] : dh;
        }
      }
    }
    if (tid < kRows) {  // step t - 1's flags (its buffer is free)
      valid[(cur ^ 1) * kRows + tid] = v_next;
      atts[(cur ^ 1) * kRows + tid] = a_next;
    }
  }
}

bool widths_ok(int64_t n_rows, int L, int d, int g) {
  return n_rows > 0 && L > 0 && d >= 1 && d <= kMaxWidth && g >= 1 &&
         g <= kMaxWidth;
}

template <typename Kernel, typename... A>
cudaError_t launch(Kernel kernel, int64_t n_rows, int units, int64_t smem,
                   cudaStream_t stream, A... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((n_rows + kRows - 1) / kRows), threads(units), smem,
           stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace gs
}  // namespace

// The forward of n_rows rows. xs f32 [n_rows, L, d], mask bool [n_rows, L],
// att f32 [n_rows, L] or NULL (the GRU), wg [2g, d + g], bg [2g], wc
// [g, d + g], bc [g], all contiguous; order int64 [n_rows], the rows
// longest span first, and span int64 [n_rows] (ops/recurrence.py). Writes
// hs [n_rows, L, g] (the GRU: every state; the AUGRU: the states of the
// span, for its backward, or NULL), last [n_rows, g] (the AUGRU; NULL for
// the GRU) and gates [n_rows, L, 3g] at the valid positions (NULL: not
// kept). d and g in [1, 64], n_rows and L above 0, else
// cudaErrorInvalidValue unlaunched. Returns the launch's cudaError_t; 0 is
// success. Never syncs.
extern "C" int deeprec_gru_scan(const void* xs, const void* mask,
                                const void* att, const void* wg,
                                const void* bg, const void* wc,
                                const void* bc, const void* order,
                                const void* span, void* hs, void* last,
                                void* gates, int64_t n_rows, int L, int d,
                                int g, void* stream) {
  if (!gs::widths_ok(n_rows, L, d, g) || (att ? !last : !hs))
    return (int)cudaErrorInvalidValue;
  const int64_t smem = (int64_t)gs::fwd_layout(d, g).total * 4;
  cudaStream_t st = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    return gs::launch(kernel, n_rows, 3 * g, smem, st, (const float*)xs,
                      (const uint8_t*)mask, (const float*)att,
                      (const float*)wg, (const float*)bg, (const float*)wc,
                      (const float*)bc, (const int64_t*)order,
                      (const int64_t*)span, (float*)hs, (float*)last,
                      (float*)gates, n_rows, L, d, g);
  };
  return (int)(att ? args(gs::gru_scan_forward_kernel<true>)
                   : args(gs::gru_scan_forward_kernel<false>));
}

// The backward of deeprec_gru_scan's training call. xs as it took them, hs
// and gates as it wrote them; grad f32 [n_rows, L, g] (the GRU's states)
// or [n_rows, g] (the AUGRU's last state). Writes dx [n_rows, L, d], d_pre
// [n_rows, L, 3g] (the gradients of z, r and n before their activations;
// zero at padded positions), act [n_rows, L, w_act] (x_t, h_{t-1},
// r h_{t-1}, 1, then zeros at valid positions, else all zero; w_act =
// d + 2g + 1 rounded up to a multiple of 4, else cudaErrorInvalidValue)
// and, for the AUGRU, d_att [n_rows, L].
extern "C" int deeprec_gru_scan_backward(
    const void* mask, const void* att, const void* wg, const void* wc,
    const void* order, const void* span, const void* xs, const void* hs,
    const void* gates, const void* grad, void* dx, void* d_pre, void* act,
    void* d_att, int64_t n_rows, int L, int d, int g, int w_act,
    void* stream) {
  if (!gs::widths_ok(n_rows, L, d, g) ||
      (att != nullptr) != (d_att != nullptr) ||
      w_act != gs::act_width(d, g))
    return (int)cudaErrorInvalidValue;
  const int64_t smem =
      (int64_t)gs::bwd_layout(d, g, gs::stage_row(d, g, att != nullptr))
          .total * 4;
  cudaStream_t st = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    return gs::launch(kernel, n_rows, d + g, smem, st, (const uint8_t*)mask,
                      (const float*)att, (const float*)wg, (const float*)wc,
                      (const int64_t*)order, (const int64_t*)span,
                      (const float*)xs, (const float*)hs,
                      (const float*)gates, (const float*)grad, (float*)dx,
                      (float*)d_pre, (float*)act, (float*)d_att, n_rows, L,
                      d, g);
  };
  return (int)(att ? args(gs::gru_scan_backward_kernel<true>)
                   : args(gs::gru_scan_backward_kernel<false>));
}
