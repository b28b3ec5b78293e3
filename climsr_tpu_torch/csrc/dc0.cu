// The fusion head's 9x9 input gradient to channel 0 by projection and
// shift-adds, for Hopper (sm_90a): two variants of one plan.
//
// Replaces the TPU kernels `_dc0_kernel` ("flat") and `_dc0_kernel_dyfac`
// ("dyfac") of scripts/bench_head_bwd_probe.py:48,68 (reached through
// `dc0_pallas` :94), which compute kernel C's function
//
//   out[n, y, x] = sum over dy, dx in -4..4 and c < C of
//                  w1c0[4 - dy, 4 - dx, c] * g[n, y + dy, x + dx, c]     (g zero outside)
//
// by their plan: first project every pixel's C channels of g onto the 81
// spatially reversed taps, V[t][p] = sum_c Wrev[t][c] * g[p][c] (a K = C
// product, f32 sums kept in f32 as the TPU's `v` scratch is), then add V's rows
// shifted into place:
//
// - flat: V has a row per tap at 9*dy + dx (81 rows; the projection is 96
//   columns wide, 81 used); out[p] = sum over the 81 taps of V[t][p + delta_t];
// - dyfac: the rows sit at 16*dy + dx (144 columns, the TPU's aligned groups);
//   first 9 dy-shifted adds give A[dx][p] = sum_dy V[16*dy + dx][p + dy rows],
//   then 9 dx-shifted adds give out[p] = sum_dx A[dx][p + dx].
//
// g is N x H x W x C (a channels_last tensor), out N x H x W, in g's type.
// What is ported is the computation, not the TPU's layout: no (C, N*H*W)
// relayout, no lane rolls and masks (g is staged with zeros outside the
// image, so a shifted read needs no mask), any H and W.
//
// Design. One block per 8 x 8 output tile of one image. It stages the tile's
// 16 x 16 source pixels (a 4-pixel halo) and holds V for all of them in shared
// memory as f32: 81 rows (flat) or 137 (dyfac, up to its last used row) of 256
// pixels, 84 KB or 143 KB. A 16 x 16 output tile would need 24 x 24 x 88 x 4 =
// 203 KB of V alone; the 8 x 8 tile keeps V and the staged g inside one
// block's 227 KB, at the price of projecting each source pixel four times
// (the halo) where a larger tile would project it fewer.
//
// - bfloat16: the projection runs on the tensor cores (mma.sync m16n8k16,
//   bf16 in, f32 sums) with g pixel-major in shared memory (C + 8 channels
//   per pixel, so ldmatrix rows fall on distinct banks) and the reversed taps
//   packed by the wrapper in B-fragment order. Each warp item is 32 pixels x
//   48 columns; V's row stride (260 floats) spreads its stores over the banks.
// - float32: each thread projects one source pixel on the CUDA cores, 16
//   channels of g at a time read straight into registers.
//
// Bound on this card: at the training head's shape (192 x 64 x 128 x 128,
// bf16) the kernel must read 403 MB of g (0.120 ms at 3.35 TB/s) and write
// 6 MB, while the projection is 16.3 G multiply-adds (0.033 ms on the tensor
// cores): bound by bytes, like kernel C. The four-fold projection of the halo
// stays under the byte bound on the tensor cores; what this first version pays
// is the round trip of V through shared memory and one block per SM.

#include "rdb_common.cuh"

namespace {

using namespace rdb;

constexpr int kT = 8;          // output tile: kT x kT pixels
constexpr int kS = kT + 8;     // source tile with the 4-pixel halo
constexpr int kSP = kS * kS;   // 256 source pixels
constexpr int kVS = kSP + 4;   // V's row stride in floats
constexpr int kChunk = 16;     // f32 path: channels of g per pass
constexpr int kGroupsPerItem = 3;  // bf16 path: 16-column groups per warp item

template <bool kDyfac>
struct Layout {
  static constexpr int kPerDy = kDyfac ? 16 : 9;    // tap (dy, dx) is row kPerDy * dy + dx
  static constexpr int kNPad = kDyfac ? 144 : 96;   // projection width: whole groups of 16
  static constexpr int kRows = kPerDy * 8 + 9;      // rows of V kept: through the last tap
  static constexpr size_t kVBytes = (size_t)kRows * kVS * sizeof(float);
  static constexpr size_t kABytes = kDyfac ? (size_t)9 * kT * kS * sizeof(float) : 0;
};

template <bool kDyfac>
__device__ __forceinline__ bool used_row(int n) {
  return kDyfac ? (n % 16) < 9 : true;
}

__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// The shift-adds from V (kRows x kVS f32 in shared memory) to the block's 8 x 8
// outputs. `a9` is the dyfac variant's [9][kT][kS] buffer.
template <bool kDyfac, class T>
__device__ __forceinline__ void shift_add(const float* v, float* a9, T* __restrict__ out, int H, int W) {
  const int tid = threadIdx.x;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int y0 = blockIdx.y * kT, x0 = blockIdx.x * kT;
  if (!kDyfac) {
    // 64 outputs x 4 threads; thread j sums the tap rows dy = j, j + 4, j + 8
    const int o = tid >> 2, j = tid & 3, y = o / kT, x = o % kT;
    float s = 0.f;
    for (int dy = j; dy < 9; dy += 4)
#pragma unroll
      for (int dx = 0; dx < 9; ++dx) s += v[(9 * dy + dx) * kVS + (y + dy) * kS + x + dx];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (j == 0 && y0 + y < H && x0 + x < W) store(out + img + (size_t)(y0 + y) * W + x0 + x, s);
    return;
  }
  // 9 dy-shifted adds: a9[dx][y][xs] = sum_dy V[16 dy + dx][(y + dy) * kS + xs]
  for (int i = tid; i < 9 * kT * kS; i += kThreads) {
    const int dx = i / (kT * kS), r = i % (kT * kS);
    float s = 0.f;
#pragma unroll
    for (int dy = 0; dy < 9; ++dy) s += v[(16 * dy + dx) * kVS + r + dy * kS];
    a9[i] = s;
  }
  __syncthreads();
  // 9 dx-shifted adds
  if (tid < kT * kT) {
    const int y = tid / kT, x = tid % kT;
    float s = 0.f;
#pragma unroll
    for (int dx = 0; dx < 9; ++dx) s += a9[dx * kT * kS + y * kS + x + dx];
    if (y0 + y < H && x0 + x < W) store(out + img + (size_t)(y0 + y) * W + x0 + x, s);
  }
}

template <bool kDyfac>
__global__ void __launch_bounds__(kThreads)
    dc0_bf16_kernel(const bf16* __restrict__ g, const uint4* __restrict__ w, bf16* __restrict__ out, int H, int W,
                    int C) {
  using L = Layout<kDyfac>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* v = reinterpret_cast<float*>(smem_raw);                            // [kRows][kVS]
  float* a9 = reinterpret_cast<float*>(smem_raw + L::kVBytes);              // [9][kT][kS] (dyfac)
  bf16* gs = reinterpret_cast<bf16*>(smem_raw + L::kVBytes + L::kABytes);   // [kSP][C + kPad]
  const int cp = C + kPad, tid = threadIdx.x;
  const int oy = blockIdx.y * kT - 4, ox = blockIdx.x * kT - 4;  // image coordinates of source pixel 0
  const size_t img = (size_t)blockIdx.z * H * W;

  // the source tile, 8 channels (16 bytes) at a time; zero outside the image
  const int vecs = C / 8;
  for (int i = tid; i < kSP * vecs; i += kThreads) {
    const int vv = i % vecs, pix = i / vecs;
    const int gy = oy + pix / kS, gx = ox + pix % kS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = *reinterpret_cast<const uint4*>(g + (img + (size_t)gy * W + gx) * C + vv * 8);
    *reinterpret_cast<uint4*>(gs + pix * cp + vv * 8) = val;
  }
  __syncthreads();

  // V = g (256 x C) @ Wrev^T (C x kNPad) on the tensor cores, rows kept up to kRows
  const int lane = tid & 31, warp = tid >> 5, ksteps = C / 16;
  constexpr int kChunks = L::kNPad / 16 / kGroupsPerItem;
  for (int item = warp; item < (kSP / 32) * kChunks; item += kWarps) {
    const int mg = item % (kSP / 32), chunk = item / (kSP / 32);
    int base[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      base[mt] = (mg * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * cp + (lane >> 4) * 8;
    float acc[2][2 * kGroupsPerItem][4] = {};
#pragma unroll 1
    for (int s = 0; s < ksteps; ++s) {
      unsigned a[2][4];
      ldmatrix_x4(a[0], gs + base[0] + s * 16);
      ldmatrix_x4(a[1], gs + base[1] + s * 16);
#pragma unroll
      for (int j = 0; j < kGroupsPerItem; ++j) {
        const uint4 bw = __ldg(w + ((size_t)(chunk * kGroupsPerItem + j) * ksteps + s) * 32 + lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * j], a[mt], bw.x, bw.y);
          mma_bf16(acc[mt][2 * j + 1], a[mt], bw.z, bw.w);
        }
      }
    }
    const int gq = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mg * 32 + mt * 16 + gq + 8 * half;
#pragma unroll
        for (int nt = 0; nt < 2 * kGroupsPerItem; ++nt) {
          const int n = chunk * kGroupsPerItem * 16 + nt * 8 + 2 * t;
          if (n < L::kRows) v[n * kVS + m] = acc[mt][nt][2 * half];
          if (n + 1 < L::kRows) v[(n + 1) * kVS + m] = acc[mt][nt][2 * half + 1];
        }
      }
  }
  __syncthreads();
  shift_add<kDyfac>(v, a9, out, H, W);
}

template <bool kDyfac>
__global__ void __launch_bounds__(kThreads)
    dc0_f32_kernel(const float* __restrict__ g, const float* __restrict__ w, float* __restrict__ out, int H, int W,
                   int C) {
  using L = Layout<kDyfac>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* v = reinterpret_cast<float*>(smem_raw);                 // [kRows][kVS]
  float* a9 = reinterpret_cast<float*>(smem_raw + L::kVBytes);   // [9][kT][kS] (dyfac)
  float* wl = reinterpret_cast<float*>(smem_raw + L::kVBytes + L::kABytes);  // [kRows][kChunk]
  const int tid = threadIdx.x;  // one source pixel per thread
  const int gy = blockIdx.y * kT - 4 + tid / kS, gx = blockIdx.x * kT - 4 + tid % kS;
  const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
  const float* gp = inside ? g + ((size_t)blockIdx.z * H * W + (size_t)gy * W + gx) * C : g;

  for (int n = 0; n < L::kRows; ++n) v[n * kVS + tid] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the last chunk's weights are read
    for (int i = tid; i < L::kRows * kChunk; i += kThreads) wl[i] = w[(size_t)(i / kChunk) * C + c0 + i % kChunk];
    float gr[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const float4 f = inside ? *reinterpret_cast<const float4*>(gp + c0 + 4 * q) : make_float4(0.f, 0.f, 0.f, 0.f);
      gr[4 * q] = f.x, gr[4 * q + 1] = f.y, gr[4 * q + 2] = f.z, gr[4 * q + 3] = f.w;
    }
    __syncthreads();
#pragma unroll 1
    for (int n = 0; n < L::kRows; ++n) {
      if (!used_row<kDyfac>(n)) continue;
      float s = v[n * kVS + tid];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) s = fmaf(wl[n * kChunk + c], gr[c], s);
      v[n * kVS + tid] = s;
    }
  }
  __syncthreads();
  shift_add<kDyfac>(v, a9, out, H, W);
}

template <bool kDyfac>
int launch(const void* g, const void* w, void* out, int n, int h, int w_, int c, int is_bf16, cudaStream_t s) {
  using L = Layout<kDyfac>;
  const dim3 grid((w_ + kT - 1) / kT, (h + kT - 1) / kT, n);
  cudaError_t err;
  if (is_bf16) {
    const size_t smem = L::kVBytes + L::kABytes + (size_t)kSP * (c + kPad) * sizeof(bf16);
    auto kernel = dc0_bf16_kernel<kDyfac>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess)
      return (int)err;
    kernel<<<grid, kThreads, smem, s>>>(static_cast<const bf16*>(g), static_cast<const uint4*>(w),
                                        static_cast<bf16*>(out), h, w_, c);
  } else {
    const size_t smem = L::kVBytes + L::kABytes + (size_t)L::kRows * kChunk * sizeof(float);
    auto kernel = dc0_f32_kernel<kDyfac>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess)
      return (int)err;
    kernel<<<grid, kThreads, smem, s>>>(static_cast<const float*>(g), static_cast<const float*>(w),
                                        static_cast<float*>(out), h, w_, c);
  }
  return (int)cudaGetLastError();
}

int entry(bool dyfac, const void* g, const void* w, void* out, int n, int h, int w_, int c, int is_bf16,
          void* stream) {
  if (n < 1 || h < 1 || w_ < 1 || n > 65535 || c < 16 || c > 128 || c % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dyfac ? launch<true>(g, w, out, n, h, w_, c, is_bf16, s) : launch<false>(g, w, out, n, h, w_, c, is_bf16, s);
}

}  // namespace

// Plain C entry points (bound with ctypes): g (N x H x W x C, C a multiple of
// 16 up to 128), out (N x H x W), w the reversed taps as rows of the variant's
// layout (96 x C flat, 144 x C dyfac), in bf16 B-fragment order (is_bf16) or
// as a row-major f32 matrix. Each returns a cudaError_t value; 0 is success.
extern "C" int climsr_dc0_flat(const void* g, const void* w, void* out, int n, int h, int w_, int c, int is_bf16,
                               void* stream) {
  return entry(false, g, w, out, n, h, w_, c, is_bf16, stream);
}

extern "C" int climsr_dc0_dyfac(const void* g, const void* w, void* out, int n, int h, int w_, int c, int is_bf16,
                                void* stream) {
  return entry(true, g, w, out, n, h, w_, c, is_bf16, stream);
}
