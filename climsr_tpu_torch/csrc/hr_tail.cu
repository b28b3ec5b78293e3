// ESRGAN's HR tail in one pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_hr_tail_kernel` (climsr_tpu/ops/pallas/head.py:58,
// reached through `_hr_tail_pallas_raw` :120 and the public `fused_hr_tail`
// :173):
//
//   a   = lrelu_0.2(x)                                   rounded to x's type
//   h   = lrelu_0.2(conv3x3(a, Whr) + bhr)   64 -> 64    f32 sums, rounded to x's type
//   out = conv3x3(h, Wcl) + bcl              64 -> 1     f32 sums, rounded once
//
// with SAME padding at both convs. x is N x H x W x 64 (a channels_last
// tensor), out is N x H x W. The weights come rounded to x's type (as the
// plain version reads them), the biases as f32.
//
// Design. Each block owns a 16 x 16 output tile of one image. It stages
// lrelu(x) with a 2-pixel halo (20 x 20 pixels) in shared memory, computes
// HRconv over the tile plus a 1-pixel ring (18 x 18 pixels) into a second
// shared buffer (zero at positions outside the image, which is conv_last's
// SAME padding), and then each of the 256 threads sums one output pixel's
// 9 x 64 conv_last products in f32. The 64-channel intermediate never leaves
// the SM; device memory sees x once and the output once.
//
// - bfloat16 (`hr_tail_bf16_kernel`): HRconv is an implicit GEMM on the tensor
//   cores, `conv3x3_mma` of rdb_common.cuh (mma.sync m16n8k16, f32 sums), over
//   a pixel-major buffer padded to 72 channels; the weights come packed in
//   B-fragment order. The intermediate is pixel-major with 66 channels per
//   pixel, so the 32 threads of a warp read 32 neighbouring pixels from
//   32 distinct banks in conv_last.
// - float32 (`hr_tail_f32_kernel`): HRconv on the CUDA cores (`conv3x3_fma`)
//   over channel-major planes, weights tap-major [tap][cin][cout].
//
// Bound on this card: at the training head's shape (192 x 64 x 128 x 128,
// bf16) the tail does 2.36e11 operations (74,880 per pixel: 0.238 ms at the
// dense bf16 rate) and must move 409 MB (0.122 ms at 3.35 TB/s), so it is
// bound by operations. The halo recompute (18 x 18 HRconv pixels per 16 x 16
// outputs, 1.27x) and mma.sync instead of wgmma are what it pays.

#include "rdb_common.cuh"

namespace {

using namespace rdb;

constexpr int kT = 16;          // output tile: kT x kT pixels, one per thread
constexpr int kX = kT + 4;      // staged lrelu(x): 2-pixel halo
constexpr int kR = kT + 2;      // HRconv region: 1-pixel ring
constexpr int kC = 64;          // channels of x and of HRconv
constexpr int kXP = kC + kPad;  // bf16 staged x: channels per pixel
constexpr int kHP = kC + 2;     // bf16 intermediate: channels per pixel (33 words)
static_assert(kT * kT == kThreads, "one output pixel per thread");

constexpr size_t kSmemBf16 = (size_t)kX * kX * kXP * 2 + (size_t)kR * kR * kHP * 2 + 9 * kC * 4;
constexpr size_t kSmemF32 = (size_t)kC * kX * kX * 4 + (size_t)kC * kR * kR * 4 + 9 * kC * 4;

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.2f * v; }

// HRconv epilogue: bias, lrelu, round to bf16, into the intermediate; zero
// outside the image (conv_last's SAME padding)
struct HiddenStore {
  bf16* hid;
  const float* b;
  int oy, ox, H, W;
  __device__ __forceinline__ void operator()(int sy, int sx, int c, float v0, float v1) const {
    const int gy = oy + sy, gx = ox + sx;
    __nv_bfloat162 r = __floats2bfloat162_rn(0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) r = __floats2bfloat162_rn(lrelu(v0 + b[c]), lrelu(v1 + b[c + 1]));
    *reinterpret_cast<__nv_bfloat162*>(hid + ((sy - 1) * kR + sx - 1) * kHP + c) = r;
  }
};

__global__ void __launch_bounds__(kThreads)
    hr_tail_bf16_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, const uint4* __restrict__ whr,
                        const float* __restrict__ bhr, const float* __restrict__ wcl, const float* __restrict__ bcl,
                        int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                    // [kX * kX][kXP]
  bf16* hid = xs + kX * kX * kXP;                                   // [kR * kR][kHP]
  float* wl = reinterpret_cast<float*>(hid + kR * kR * kHP);        // [9][kC]
  const int tid = threadIdx.x;
  const int oy = blockIdx.y * kT - 2, ox = blockIdx.x * kT - 2;  // image coordinates of xs pixel (0, 0)
  const size_t img = (size_t)blockIdx.z * H * W;

  // lrelu(x) with its halo, 8 channels (16 bytes) at a time; zero outside the image
  for (int i = tid; i < kX * kX * (kC / 8); i += kThreads) {
    const int v = i % (kC / 8), pix = i / (kC / 8);
    const int gy = oy + pix / kX, gx = ox + pix % kX;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      val = *reinterpret_cast<const uint4*>(x + (img + (size_t)gy * W + gx) * kC + v * 8);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(lrelu(__low2float(h[j])), lrelu(__high2float(h[j])));
    }
    *reinterpret_cast<uint4*>(xs + pix * kXP + v * 8) = val;
  }
  for (int i = tid; i < 9 * kC; i += kThreads) wl[i] = wcl[i];
  __syncthreads();

  conv3x3_mma(xs, kXP, kX, 1, kR, kR, kC, kC, whr, HiddenStore{hid, bhr, oy, ox, H, W});
  __syncthreads();

  const int ty = tid / kT, tx = tid % kT;
  float acc = 0.f;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const __nv_bfloat162* h =
        reinterpret_cast<const __nv_bfloat162*>(hid + ((ty + tap / 3) * kR + tx + tap % 3) * kHP);
    const float* w = wl + tap * kC;
#pragma unroll 8
    for (int c = 0; c < kC / 2; ++c) {
      const __nv_bfloat162 v = h[c];
      acc = fmaf(__low2float(v), w[2 * c], acc);
      acc = fmaf(__high2float(v), w[2 * c + 1], acc);
    }
  }
  const int gy = blockIdx.y * kT + ty, gx = blockIdx.x * kT + tx;
  if (gy < H && gx < W) out[img + (size_t)gy * W + gx] = __float2bfloat16_rn(acc + *bcl);
}

__global__ void __launch_bounds__(kThreads)
    hr_tail_f32_kernel(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ whr,
                       const float* __restrict__ bhr, const float* __restrict__ wcl, const float* __restrict__ bcl,
                       int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kXPlane = kX * kX, kRPlane = kR * kR;
  float* xs = reinterpret_cast<float*>(smem_raw);  // [kC][kX * kX]
  float* hid = xs + kC * kXPlane;                   // [kC][kR * kR]
  float* wl = hid + kC * kRPlane;                   // [9][kC]
  const int tid = threadIdx.x;
  const int oy = blockIdx.y * kT - 2, ox = blockIdx.x * kT - 2;
  const size_t img = (size_t)blockIdx.z * H * W;

  for (int i = tid; i < kXPlane * kC; i += kThreads) {
    const int c = i % kC, pix = i / kC;
    const int gy = oy + pix / kX, gx = ox + pix % kX;
    xs[c * kXPlane + pix] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W) ? lrelu(x[(img + (size_t)gy * W + gx) * kC + c]) : 0.f;
  }
  for (int i = tid; i < 9 * kC; i += kThreads) wl[i] = wcl[i];
  __syncthreads();

  // HRconv over the 18 x 18 region, kP pixels x kQ channels per work item
  constexpr int kPairs = kR / kP, kItems = kR * kPairs * (kC / kQ);
  for (int it = tid; it < kItems; it += kThreads) {
    const int g = it / (kR * kPairs), pr = it % (kR * kPairs);
    const int sy = 1 + pr / kPairs, sx = 1 + (pr % kPairs) * kP;  // xs coordinates
    float acc[kP][kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int p = 0; p < kP; ++p) acc[p][q] = bhr[g * kQ + q];
    conv3x3_fma(acc, xs, kC, kXPlane, kX, whr + g * kQ, kC, sy, sx);
    const int gy = oy + sy;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int gx = ox + sx + p;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float* dst = hid + (size_t)(g * kQ) * kRPlane + (sy - 1) * kR + sx - 1 + p;
#pragma unroll
      for (int q = 0; q < kQ; ++q) dst[q * kRPlane] = inside ? lrelu(acc[p][q]) : 0.f;
    }
  }
  __syncthreads();

  const int ty = tid / kT, tx = tid % kT;
  float acc = 0.f;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const float* h = hid + (ty + tap / 3) * kR + tx + tap % 3;
    const float* w = wl + tap * kC;
#pragma unroll 8
    for (int c = 0; c < kC; ++c) acc = fmaf(h[c * kRPlane], w[c], acc);
  }
  const int gy = blockIdx.y * kT + ty, gx = blockIdx.x * kT + tx;
  if (gy < H && gx < W) out[img + (size_t)gy * W + gx] = acc + *bcl;
}

}  // namespace

// Plain C entry point (bound with ctypes): x (N x H x W x 64), out (N x H x W),
// whr packed for the type (bf16 B-fragment order, or f32 tap-major
// [tap][cin][cout]), bhr (64 f32), wcl (9 x 64 f32, [tap][cin]), bcl (1 f32).
// Returns a cudaError_t value; 0 is success.
extern "C" int climsr_hr_tail(const void* x, void* out, const void* whr, const float* bhr, const float* wcl,
                              const float* bcl, int n, int h, int w, int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kT - 1) / kT, (h + kT - 1) / kT, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    if ((err = cudaFuncSetAttribute(hr_tail_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kSmemBf16)) != cudaSuccess)
      return (int)err;
    hr_tail_bf16_kernel<<<grid, kThreads, kSmemBf16, s>>>(static_cast<const bf16*>(x), static_cast<bf16*>(out),
                                                           static_cast<const uint4*>(whr), bhr, wcl, bcl, h, w);
  } else {
    if ((err = cudaFuncSetAttribute(hr_tail_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kSmemF32)) != cudaSuccess)
      return (int)err;
    hr_tail_f32_kernel<<<grid, kThreads, kSmemF32, s>>>(static_cast<const float*>(x), static_cast<float*>(out),
                                                         static_cast<const float*>(whr), bhr, wcl, bcl, h, w);
  }
  return (int)cudaGetLastError();
}
