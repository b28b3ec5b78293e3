// The ESRGAN discriminator's chain between its convolutions, forward and backward, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's discriminator leaves this chain to
// XLA, which fuses the elementwise steps into its convolutions' neighbours. On
// the card, PyTorch runs it as separate passes over every activation: the conv
// bias as its own broadcast add, LeakyReLU, BatchNorm's f32 copy of its bf16
// input, the f32 normalisation, the cast back and a reflection pad that copies
// the whole tensor, and as many passes again in the backward. Each block of D
// (conv3, bias, LeakyReLU, BatchNorm, reflect-pad 1, strided conv3, bias,
// LeakyReLU, the next block's reflect-pad 1) becomes two fused ops:
//
//   bias_leaky_bn_pad:  out = pad(bn(lrelu(y + b)))     (y: the conv's output without its bias)
//   bias_leaky_pad:     out = pad(lrelu(y + b))
//
// Roundings are the module chain's: the bias add and the LeakyReLU each round
// to the working type T (bf16 or f32), BatchNorm runs in f32 from that rounded
// value and its result is rounded once. The backward folds the pad's border
// gradients in f32 and rounds the folded gradient once to T (the pad's
// gradient is a T tensor in the chain), rounds BatchNorm's input gradient to T
// (the backward of the chain's cast), applies the LeakyReLU mask in T and sums
// the rounded result for the conv bias' gradient.
//
// Bound on this card: bytes. The ops do a few operations per element, far
// below the ~300 a byte at which an H100's arithmetic would set the pace, so
// the least time is the bytes over 3.35 TB/s. At D's first block (192 x 64 x
// 128 x 128 in bf16, T = 403 MB) the module chain moves about 16 T forward;
// these kernels move 3 T (the statistics pass reads y, the apply pass reads y
// again and writes the padded output) and 5 T backward (one pass reads the
// padded gradient and y for BatchNorm's two sums, the next reads both again and
// writes the conv's gradient).
//
// Design:
// - NHWC (torch.channels_last). A thread owns 8 channels of a pixel, one
//   16-byte vector of bf16 (two of f32); a block of 256 threads is 8 lanes
//   across 64 channels by 32 pixel rows, and grid.y walks the 64-channel
//   chunks (C any multiple of 8; lanes past C idle). grid.x cuts the pixels
//   into contiguous parts, enough blocks to fill the 132 SMs; each thread
//   loads 4 pixels before it computes, so loads stay in flight.
// - Sums across blocks (BatchNorm's statistics, its two backward sums, the
//   conv bias' gradient) are per-block f32 partials in scratch the wrapper
//   allocates, each block's rows combined in a fixed order, then reduced by one
//   small finalize launch (a block per channel, a fixed tree). No float
//   atomics: the statistics and gradients repeat bitwise.
// - The statistics are Welford's per thread and Chan's combination above it,
//   never E[x^2] - E[x]^2. The finalize launch updates the running statistics
//   as torch's BatchNorm does (momentum on the batch mean and the unbiased
//   variance) and adds one to num_batches_tracked.
// - The pad is a gather in the apply pass (each output pixel reads its
//   reflected source) and a fold in the backward (each source pixel adds the
//   1-4 padded positions that read it), so no padded copy is ever made.
// - Only the conv's output y is saved for the backward of bias_leaky_bn_pad
//   (and the output, which the next conv keeps anyway, for bias_leaky_pad's
//   mask); BatchNorm's f32 input is never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLanes = 8;                 // threads across a block's channels, 8 channels each
constexpr int kRows = 32;                 // pixel rows of a block
constexpr int kThreads = kLanes * kRows;  // 256
constexpr int kChunk = 8 * kLanes;        // a block's channels
constexpr int kUnroll = 4;                // pixels a thread loads before it computes
constexpr int kFinThreads = 256;          // a finalize block: one channel

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A thread's 8 channels as loaded, kept packed until they are used (half the
// registers of 8 floats in bf16), so that several pixels' loads are in flight.
template <typename T>
struct Raw;
template <>
struct Raw<bf16> {
  uint4 v;
};
template <>
struct Raw<float> {
  float4 a, b;
};

__device__ __forceinline__ Raw<bf16> load_raw(const bf16* p) { return {__ldg(reinterpret_cast<const uint4*>(p))}; }

__device__ __forceinline__ Raw<float> load_raw(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldg(q), __ldg(q + 1)};
}

__device__ __forceinline__ void unpack(const Raw<bf16>& r, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const Raw<float>& r, float v[8]) {
  v[0] = r.a.x, v[1] = r.a.y, v[2] = r.a.z, v[3] = r.a.w, v[4] = r.b.x, v[5] = r.b.y, v[6] = r.b.z, v[7] = r.b.w;
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float v[8]) {
  unpack(load_raw(p), v);
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// LeakyReLU in T: x > 0 passes, else x * slope rounded to T (torch's op on a T tensor).
template <typename T>
__device__ __forceinline__ float leaky(float x, float slope) {
  return x > 0.f ? x : rnd<T>(x * slope);
}

__device__ __forceinline__ int reflect1(int i, int n) {  // source index of padded index i + 1, pad 1
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

// Part i of `total` items cut into `parts` contiguous parts (the wrapper
// keeps N (H + 2) (W + 2) under 2^31, so pixel indices are 32-bit).
__device__ __forceinline__ void part_range(int total, int parts, int i, int& lo, int& hi) {
  const int per = (total + parts - 1) / parts;
  lo = min(total, i * per);
  hi = min(total, lo + per);
}

// Pixel index p of an (N, H, W) grid as (n, h, w).
__device__ __forceinline__ void decode(int p, int H, int W, int& n, int& h, int& w) {
  n = p / (H * W);
  const int r = p - n * H * W;
  h = r / W;
  w = r - h * W;
}

// Chan's combination of (n, mean, m2) with (nb, mb, m2b).
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb, d = mb - mean, f = nb / nn;
  mean += d * f;
  m2 += m2b + d * d * n * f;
  n = nn;
}

// The 8 channels at c0 of the gradient at source pixel (n, h, w) of a reflect
// pad 1: the padded position (h + 1, w + 1), already in g, plus the border
// positions that reflect onto it, summed in f32 in a fixed order.
template <typename T>
__device__ __forceinline__ void add_borders(const T* gp, int n, int h, int w, int H, int W, int C, int c0,
                                            float g[8]) {
  const bool r0 = h == 1, r1 = h == H - 2, q0 = w == 1, q1 = w == W - 2;
  if (!(r0 || r1 || q0 || q1)) return;
  const int rows[3] = {h + 1, 0, H + 1}, cols[3] = {w + 1, 0, W + 1};
  const bool ron[3] = {true, r0, r1}, con[3] = {true, q0, q1};
  float t[8];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if ((i | j) == 0 || !ron[i] || !con[j]) continue;
      load8(gp + ((size_t)(n * (H + 2) + rows[i]) * (W + 2) + cols[j]) * C + c0, t);
#pragma unroll
      for (int k = 0; k < 8; ++k) g[k] += t[k];
    }
  }
}

// Sum each of A rows-by-chunk tiles of shared memory over its 32 rows in
// order and write the block's partial for each channel of its chunk.
template <int A>
__device__ __forceinline__ void write_partials(float (*s)[kRows][kChunk], int C, int parts, float* part) {
  __syncthreads();
  const int j = threadIdx.x, c = blockIdx.y * kChunk + j;
  if (j < kChunk && c < C) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float sum = 0.f;
      for (int r = 0; r < kRows; ++r) sum += s[a][r][j];
      part[((size_t)a * C + c) * parts + blockIdx.x] = sum;
    }
  }
}

// ---------------------------------------------------------------- forward

// Pass 1 of bias_leaky_bn_pad: per-block Welford statistics of a = lrelu(y + b).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) stats_kernel(const T* __restrict__ y, const float* __restrict__ bias,
                                                            int P, int C, int parts, float slope,
                                                            float* __restrict__ part) {
  __shared__ float s[2][kRows][kChunk];
  __shared__ float s_n[kRows];
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes, c0 = blockIdx.y * kChunk + lane * 8;
  float mean[8] = {}, m2[8] = {}, b[8], n = 0.f;
  if (c0 < C) {
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = rnd<T>(bias[c0 + k]);
    int lo, hi;
    part_range(P, parts, blockIdx.x, lo, hi);
    for (int p = lo + row; p < hi; p += kRows * kUnroll) {
      Raw<T> raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p + u * kRows < hi) raw[u] = load_raw(y + (size_t)(p + u * kRows) * C + c0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * kRows >= hi) break;
        float v[8];
        unpack(raw[u], v);
        n += 1.f;
        const float inv = 1.f / n;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float a = leaky<T>(rnd<T>(v[k] + b[k]), slope), d = a - mean[k];
          mean[k] += d * inv;
          m2[k] += d * (a - mean[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) s[0][row][lane * 8 + k] = mean[k], s[1][row][lane * 8 + k] = m2[k];
  if (lane == 0) s_n[row] = n;
  __syncthreads();
  const int j = threadIdx.x, c = blockIdx.y * kChunk + j;
  if (j < kChunk && c < C) {
    float cn = 0.f, cm = 0.f, cq = 0.f;
    for (int r = 0; r < kRows; ++r) chan(cn, cm, cq, s_n[r], s[0][r][j], s[1][r][j]);
    part[(size_t)c * parts + blockIdx.x] = cm;
    part[((size_t)C + c) * parts + blockIdx.x] = cq;
  }
}

// The batch's mean and biased variance per channel from the parts, and the
// running statistics' update (running_mean null: no update).
__global__ void __launch_bounds__(kFinThreads) stats_finalize_kernel(const float* __restrict__ part, int P, int parts,
                                                                     int C, float momentum, float* __restrict__ mean,
                                                                     float* __restrict__ var, float* running_mean,
                                                                     float* running_var, long long* nbt) {
  __shared__ float sn[kFinThreads], sm[kFinThreads], sq[kFinThreads];
  const int c = blockIdx.x, t = threadIdx.x;
  float n = 0.f, m = 0.f, q = 0.f;
  for (int i = t; i < parts; i += kFinThreads) {
    int lo, hi;
    part_range(P, parts, i, lo, hi);
    chan(n, m, q, (float)(hi - lo), part[(size_t)c * parts + i], part[((size_t)C + c) * parts + i]);
  }
  sn[t] = n, sm[t] = m, sq[t] = q;
  for (int s = kFinThreads / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (t < s) chan(sn[t], sm[t], sq[t], sn[t + s], sm[t + s], sq[t + s]);
  }
  if (t == 0) {
    mean[c] = sm[0];
    var[c] = sq[0] / (float)P;
    if (running_mean != nullptr) {
      running_mean[c] = momentum * sm[0] + (1.f - momentum) * running_mean[c];
      running_var[c] = momentum * (sq[0] / (float)(P - 1)) + (1.f - momentum) * running_var[c];
      if (c == 0) *nbt += 1;
    }
  }
}

// Sums of `parts` partials per channel, for each of gridDim.y arrays laid out
// [array][C][parts], into out[array][C]. Array 1 is scaled by 1/sqrt(var + eps)
// where var is given (BatchNorm's weight gradient); round_bf16 rounds each sum
// to bf16 (the conv bias' gradient, summed in the chain's bf16 sum).
__global__ void __launch_bounds__(kFinThreads) sums_finalize_kernel(const float* __restrict__ part, int parts, int C,
                                                                    const float* __restrict__ var, float eps,
                                                                    int round_bf16, float* __restrict__ out) {
  __shared__ float ss[kFinThreads];
  const int c = blockIdx.x, a = blockIdx.y, t = threadIdx.x;
  const float* src = part + ((size_t)a * C + c) * parts;
  float sum = 0.f;
  for (int i = t; i < parts; i += kFinThreads) sum += src[i];
  ss[t] = sum;
  for (int s = kFinThreads / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (t < s) ss[t] += ss[t + s];
  }
  if (t == 0) {
    float v = ss[0];
    if (var != nullptr && a == 1) v *= 1.f / sqrtf(var[c] + eps);
    if (round_bf16) v = rnd<bf16>(v);
    out[(size_t)a * C + c] = v;
  }
}

// The apply pass, one output pixel of (N, H + 2, W + 2) per thread and step:
// the reflected source's lrelu(y + b), normalised with (mean, var, gamma, beta)
// when BN.
template <typename T, bool BN>
__global__ void __launch_bounds__(kThreads, 2) apply_kernel(const T* __restrict__ y, const float* __restrict__ bias,
                                                            const float* __restrict__ mean,
                                                            const float* __restrict__ var,
                                                            const float* __restrict__ gamma,
                                                            const float* __restrict__ beta, int N, int H, int W,
                                                            int C, int parts, float eps, float slope,
                                                            T* __restrict__ out) {
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes, c0 = blockIdx.y * kChunk + lane * 8;
  if (c0 >= C) return;
  float b[8], mu[8], rs[8], ga[8], be[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    b[k] = rnd<T>(bias[c0 + k]);
    if constexpr (BN) mu[k] = mean[c0 + k], rs[k] = 1.f / sqrtf(var[c0 + k] + eps), ga[k] = gamma[c0 + k], be[k] = beta[c0 + k];
  }
  int lo, hi;
  part_range(N * (H + 2) * (W + 2), parts, blockIdx.x, lo, hi);
  for (int q = lo + row; q < hi; q += kRows * kUnroll) {
    Raw<T> raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q + u * kRows >= hi) break;
      int n, oy, ox;
      decode(q + u * kRows, H + 2, W + 2, n, oy, ox);
      raw[u] = load_raw(y + ((size_t)(n * H + reflect1(oy - 1, H)) * W + reflect1(ox - 1, W)) * C + c0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q + u * kRows >= hi) break;
      float o[8];
      unpack(raw[u], o);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        o[k] = leaky<T>(rnd<T>(o[k] + b[k]), slope);
        if constexpr (BN) o[k] = ((o[k] - mu[k]) * rs[k]) * ga[k] + be[k];
      }
      store8(out + (size_t)(q + u * kRows) * C + c0, o);
    }
  }
}

// ---------------------------------------------------------------- backward

// Pass 1 of bias_leaky_bn_pad's backward: per-block sums of g and g (a - mean)
// over the folded, T-rounded gradient g.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) bn_bwd_reduce_kernel(const T* __restrict__ gp,
                                                                    const T* __restrict__ y,
                                                                    const float* __restrict__ bias,
                                                                    const float* __restrict__ mean, int N, int H,
                                                                    int W, int C, int parts, float slope,
                                                                    float* __restrict__ part) {
  __shared__ float s[2][kRows][kChunk];
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes, c0 = blockIdx.y * kChunk + lane * 8;
  float sg[8] = {}, sgx[8] = {};
  if (c0 < C) {
    float b[8], mu[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = rnd<T>(bias[c0 + k]), mu[k] = mean[c0 + k];
    int lo, hi;
    part_range(N * H * W, parts, blockIdx.x, lo, hi);
    for (int p = lo + row; p < hi; p += kRows * kUnroll) {
      Raw<T> graw[kUnroll], yraw[kUnroll];
      int pn[kUnroll], ph[kUnroll], pw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * kRows >= hi) break;
        decode(p + u * kRows, H, W, pn[u], ph[u], pw[u]);
        graw[u] = load_raw(gp + ((size_t)(pn[u] * (H + 2) + ph[u] + 1) * (W + 2) + pw[u] + 1) * C + c0);
        yraw[u] = load_raw(y + (size_t)(p + u * kRows) * C + c0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * kRows >= hi) break;
        float g[8], v[8];
        unpack(graw[u], g);
        unpack(yraw[u], v);
        add_borders<T>(gp, pn[u], ph[u], pw[u], H, W, C, c0, g);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float gk = rnd<T>(g[k]), a = leaky<T>(rnd<T>(v[k] + b[k]), slope);
          sg[k] += gk;
          sgx[k] += gk * (a - mu[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) s[0][row][lane * 8 + k] = sg[k], s[1][row][lane * 8 + k] = sgx[k];
  write_partials<2>(s, C, parts, part);
}

// The gradient at the conv's output, one source pixel per thread and step.
// BN: BatchNorm's input gradient from the folded g and the sums (dbeta,
// dgamma) when train, rounded to T, then the LeakyReLU mask of lrelu(y + b).
// Not BN: the folded g rounded to T under the mask of the saved padded output
// `src` (its sign is the LeakyReLU input's). part (may be null): per-block sums
// of the result for the conv bias' gradient.
template <typename T, bool BN>
__global__ void __launch_bounds__(kThreads, 2) bwd_apply_kernel(const T* __restrict__ gp, const T* __restrict__ src,
                                                                const float* __restrict__ bias,
                                                                const float* __restrict__ mean,
                                                                const float* __restrict__ var,
                                                                const float* __restrict__ gamma,
                                                                const float* __restrict__ sums, int N, int H, int W,
                                                                int C, int parts, int train, float eps, float slope,
                                                                T* __restrict__ dy, float* __restrict__ part) {
  __shared__ float s[1][kRows][kChunk];
  const int lane = threadIdx.x % kLanes, row = threadIdx.x / kLanes, c0 = blockIdx.y * kChunk + lane * 8;
  float sdb[8] = {};
  if (c0 < C) {
    float b[8], mu[8], f1[8], f2[8], mdy[8];
    const int P = N * H * W;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (!BN) break;
      const float rs = 1.f / sqrtf(var[c0 + k] + eps);
      b[k] = rnd<T>(bias[c0 + k]), mu[k] = mean[c0 + k], f2[k] = gamma[c0 + k] * rs;
      mdy[k] = train ? sums[c0 + k] / (float)P : 0.f;
      f1[k] = train ? rs * (sums[C + c0 + k] / (float)P) : 0.f;
    }
    int lo, hi;
    part_range(P, parts, blockIdx.x, lo, hi);
    for (int p = lo + row; p < hi; p += kRows * kUnroll) {
      Raw<T> graw[kUnroll], vraw[kUnroll];
      int pn[kUnroll], ph[kUnroll], pw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * kRows >= hi) break;
        decode(p + u * kRows, H, W, pn[u], ph[u], pw[u]);
        const size_t padded = ((size_t)(pn[u] * (H + 2) + ph[u] + 1) * (W + 2) + pw[u] + 1) * C + c0;
        graw[u] = load_raw(gp + padded);
        vraw[u] = load_raw(BN ? src + (size_t)(p + u * kRows) * C + c0 : src + padded);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * kRows >= hi) break;
        float g[8], v[8], d[8];
        unpack(graw[u], g);
        unpack(vraw[u], v);
        add_borders<T>(gp, pn[u], ph[u], pw[u], H, W, C, c0, g);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float gk = rnd<T>(g[k]);
          float da, a;
          if constexpr (BN) {
            a = leaky<T>(rnd<T>(v[k] + b[k]), slope);
            da = rnd<T>((gk - mdy[k] - (a - mu[k]) * f1[k]) * f2[k]);
          } else {
            a = v[k];
            da = gk;
          }
          d[k] = a > 0.f ? da : rnd<T>(da * slope);
          sdb[k] += d[k];
        }
        store8(dy + (size_t)(p + u * kRows) * C + c0, d);
      }
    }
  }
  if (part == nullptr) return;  // uniform across the block
#pragma unroll
  for (int k = 0; k < 8; ++k) s[0][row][lane * 8 + k] = sdb[k];
  write_partials<1>(s, C, parts, part);
}

bool shape_ok(int n, int h, int w, int c, int parts) {
  return n >= 1 && h >= 2 && w >= 2 && c >= 8 && c % 8 == 0 && parts >= 1 && parts <= 65535 &&
         (long long)n * (h + 2) * (w + 2) < (1LL << 31);
}

dim3 grid_of(int c, int parts) { return dim3(parts, (c + kChunk - 1) / kChunk); }

template <typename T>
int bn_fwd(const void* y, const float* bias, const float* gamma, const float* beta, float* mean, float* var,
           float* running_mean, float* running_var, long long* nbt, float* part, int n, int h, int w, int c, int parts,
           int train, float momentum, float eps, float slope, void* out, cudaStream_t s) {
  const int P = n * h * w;
  const T* yt = static_cast<const T*>(y);
  if (train) {
    stats_kernel<T><<<grid_of(c, parts), kThreads, 0, s>>>(yt, bias, P, c, parts, slope, part);
    stats_finalize_kernel<<<c, kFinThreads, 0, s>>>(part, P, parts, c, momentum, mean, var, running_mean,
                                                    running_var, nbt);
  }
  apply_kernel<T, true><<<grid_of(c, parts), kThreads, 0, s>>>(yt, bias, mean, var, gamma, beta, n, h, w, c, parts,
                                                               eps, slope, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int bn_bwd(const void* gp, const void* y, const float* bias, const float* gamma, const float* mean, const float* var,
           float* part, float* sums, void* dy, float* db, int n, int h, int w, int c, int parts, int train, float eps,
           float slope, int round_bf16, cudaStream_t s) {
  const T* gpt = static_cast<const T*>(gp);
  const T* yt = static_cast<const T*>(y);
  if (sums != nullptr) {
    bn_bwd_reduce_kernel<T><<<grid_of(c, parts), kThreads, 0, s>>>(gpt, yt, bias, mean, n, h, w, c, parts, slope,
                                                                   part);
    sums_finalize_kernel<<<dim3(c, 2), kFinThreads, 0, s>>>(part, parts, c, var, eps, 0, sums);
  }
  if (dy != nullptr) {
    bwd_apply_kernel<T, true><<<grid_of(c, parts), kThreads, 0, s>>>(
        gpt, yt, bias, mean, var, gamma, sums, n, h, w, c, parts, train, eps, slope, static_cast<T*>(dy),
        db != nullptr ? part : nullptr);
    if (db != nullptr) sums_finalize_kernel<<<dim3(c, 1), kFinThreads, 0, s>>>(part, parts, c, nullptr, 0.f,
                                                                               round_bf16, db);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int pad_bwd(const void* gp, const void* out, float* part, float* db, int n, int h, int w, int c, int parts,
            float slope, int round_bf16, void* dy, cudaStream_t s) {
  bwd_apply_kernel<T, false><<<grid_of(c, parts), kThreads, 0, s>>>(
      static_cast<const T*>(gp), static_cast<const T*>(out), nullptr, nullptr, nullptr, nullptr, nullptr, n, h, w, c,
      parts, 0, 0.f, slope, static_cast<T*>(dy), db != nullptr ? part : nullptr);
  if (db != nullptr) sums_finalize_kernel<<<dim3(c, 1), kFinThreads, 0, s>>>(part, parts, c, nullptr, 0.f,
                                                                             round_bf16, db);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Tensors are NHWC (channels_last),
// 16-byte aligned; y, gp, out and dy are bf16 (is_bf16) or f32, every other
// pointer f32. `part` is scratch of 2 x C x parts floats. Each returns a
// cudaError_t value; 0 is success.

// bias_leaky_bn_pad forward: y (N, H, W, C) -> out (N, H + 2, W + 2, C). train:
// the batch's mean and biased var are written to `mean`, `var` and the running
// statistics updated (nbt: num_batches_tracked, int64); else `mean` and `var`
// are read (the running statistics).
extern "C" int climsr_d_tail_bn_fwd(const void* y, const float* bias, const float* gamma, const float* beta,
                                    float* mean, float* var, float* running_mean, float* running_var, long long* nbt,
                                    float* part, int n, int h, int w, int c, int parts, int train, float momentum,
                                    float eps, float slope, int is_bf16, void* out, void* stream) {
  if (!shape_ok(n, h, w, c, parts)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bn_fwd<bf16>(y, bias, gamma, beta, mean, var, running_mean, running_var, nbt, part, n, h, w, c,
                                parts, train, momentum, eps, slope, out, s)
                 : bn_fwd<float>(y, bias, gamma, beta, mean, var, running_mean, running_var, nbt, part, n, h, w, c,
                                 parts, train, momentum, eps, slope, out, s);
}

// bias_leaky_bn_pad backward: gp (N, H + 2, W + 2, C) is the output's gradient.
// sums (2 x C, may be null): dbeta then dgamma are written. dy (may be null):
// the gradient at y; train needs sums. db (may be null, needs dy): the conv
// bias' gradient.
extern "C" int climsr_d_tail_bn_bwd(const void* gp, const void* y, const float* bias, const float* gamma,
                                    const float* mean, const float* var, float* part, float* sums, void* dy,
                                    float* db, int n, int h, int w, int c, int parts, int train, float eps,
                                    float slope, int is_bf16, void* stream) {
  if (!shape_ok(n, h, w, c, parts) || (train && dy != nullptr && sums == nullptr) || (db != nullptr && dy == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bn_bwd<bf16>(gp, y, bias, gamma, mean, var, part, sums, dy, db, n, h, w, c, parts, train, eps,
                                slope, 1, s)
                 : bn_bwd<float>(gp, y, bias, gamma, mean, var, part, sums, dy, db, n, h, w, c, parts, train, eps,
                                 slope, 0, s);
}

// bias_leaky_pad forward: y (N, H, W, C) -> out (N, H + 2, W + 2, C).
extern "C" int climsr_d_tail_pad_fwd(const void* y, const float* bias, int n, int h, int w, int c, int parts,
                                     float slope, int is_bf16, void* out, void* stream) {
  if (!shape_ok(n, h, w, c, parts)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    apply_kernel<bf16, false><<<grid_of(c, parts), kThreads, 0, s>>>(
        static_cast<const bf16*>(y), bias, nullptr, nullptr, nullptr, nullptr, n, h, w, c, parts, 0.f, slope,
        static_cast<bf16*>(out));
  else
    apply_kernel<float, false><<<grid_of(c, parts), kThreads, 0, s>>>(
        static_cast<const float*>(y), bias, nullptr, nullptr, nullptr, nullptr, n, h, w, c, parts, 0.f, slope,
        static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// bias_leaky_pad backward: gp (N, H + 2, W + 2, C) the output's gradient, out
// the saved output -> dy (N, H, W, C); db (may be null) the conv bias' gradient.
extern "C" int climsr_d_tail_pad_bwd(const void* gp, const void* out, float* part, float* db, int n, int h, int w,
                                     int c, int parts, float slope, int is_bf16, void* dy, void* stream) {
  if (!shape_ok(n, h, w, c, parts)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? pad_bwd<bf16>(gp, out, part, db, n, h, w, c, parts, slope, 1, dy, s)
                 : pad_bwd<float>(gp, out, part, db, n, h, w, c, parts, slope, 0, dy, s);
}
