// Fused residual-dense-block forward for Hopper (sm_90a).
//
// Replaces two TPU kernels that share one body (`_rdb_t_forward_body`,
// climsr_tpu/ops/pallas/rdb.py:326):
//
// - A, `_rdb_t_kernel` (rdb.py:190): the forward (entry `climsr_rdb_fwd`);
// - B1, `_rdb_t_fwd_save_kernel` (rdb.py:315): the same forward that also
//   writes the feature buffer feat = [x, h_1 .. h_4] (nf + 4*gc channels, in
//   x's type, each h_k rounded exactly where the forward rounds it) as the
//   residual of the backward (entry `climsr_rdb_fwd_save`). Like the TPU
//   kernel it saves all nf + 4*gc channels, x included, so the backward reads
//   one buffer; the copy is taken from the tile's centre in shared memory after
//   the growth convs, 256 more bytes per pixel of traffic in bf16.
//
// One launch computes one RDB:
//
//   h_k = lrelu_0.2(conv3x3([x, h_1 .. h_{k-1}]) + b_k)        k = 1..4, gc channels each
//   y5  = conv3x3([x, h_1 .. h_4]) + b_5                        nf channels
//   out = x + 0.2 * y5            or, with x0,   x0 + 0.2 * (x + 0.2 * y5)
//
// Layout: x, x0 and out are N x H x W x nf (a channels_last NCHW tensor).
//
// Design (both kernels). Each block owns a th x tw output tile of one image.
// It loads x with a 5-pixel halo into a shared-memory feature buffer of
// nf + 4*gc channels. Growth conv k computes its gc channels over a region one
// pixel smaller on every side than the previous one and writes them into its
// own channel slice of that buffer, rounded to the storage type, so the
// concatenation never leaves the SM. conv5 then computes the tile and the
// epilogue adds the residual(s) and writes the block's single output. SAME
// padding holds for every conv: x and every growth value at a position
// outside the image are zero in the buffer. Sums are f32.
//
// - bfloat16 (`rdb_fwd_bf16_kernel`): every conv is an implicit GEMM on the
//   tensor cores (mma.sync m16n8k16, bf16 in, f32 sums). Rows are the region's
//   pixels, columns the output channels, K = 9 taps x cin. The buffer is
//   pixel-major (channels contiguous, padded by 8 so ldmatrix rows fall on
//   distinct banks); A fragments come from it with ldmatrix, B fragments from
//   weights the wrapper packs once in fragment order (one 16-byte load per
//   lane per k-step and 16 output channels). Each warp item is 32 pixels x 16
//   output channels.
// - float32 (`rdb_fwd_f32_kernel`): CUDA-core FMA over a channel-major buffer,
//   each work item 2 pixels x 8 output channels, weights tap-major
//   [tap][cin][cout] read through L1 (a warp-wide broadcast).
//
// Bound on this card (A): at the inference path's shape (16 tiles of 128 x 128, nf=64,
// gc=16, bf16) one launch needs 65.2 GFLOP against 100 MB of traffic, so it is
// bound by operations (66 us at the tensor cores' dense bf16 rate, 30 us of
// memory). The design keeps every intermediate on chip, so the traffic stays
// at x, x0 and out; what it pays instead is the halo recompute (~1.27x the
// useful MACs at 16 x 16 tiles) and mma.sync instead of wgmma. B1 at the
// training shape (192 x 64 x 32 x 32, bf16) needs 48.9 GFLOP (49 us) against
// 126 MB (38 us), so it is bound by operations too.

#include "rdb_common.cuh"

namespace {

using namespace rdb;

// ---------------------------------------------------------------- bfloat16, tensor cores

// Growth conv epilogue: bias, LeakyReLU, round to bf16, into the buffer's
// channel slice; zero at positions outside the image (SAME padding).
struct GrowthStore {
  bf16* feat;
  const float* b;
  int cp, pw, ch, oy, ox, H, W;
  __device__ __forceinline__ void operator()(int sy, int sx, int c, float v0, float v1) const {
    const int gy = oy + sy, gx = ox + sx;
    __nv_bfloat162 r = __floats2bfloat162_rn(0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v0 += b[c];
      v1 += b[c + 1];
      r = __floats2bfloat162_rn(v0 > 0.f ? v0 : 0.2f * v0, v1 > 0.f ? v1 : 0.2f * v1);
    }
    *reinterpret_cast<__nv_bfloat162*>(feat + (sy * pw + sx) * cp + ch + c) = r;
  }
};

// conv5 epilogue: x + 0.2 * (y5 + b5), optionally x0 + 0.2 * that, to global.
struct ResidualStore {
  const bf16* feat;
  const bf16* x0;
  bf16* out;
  const float* b;
  size_t img;
  int cp, pw, oy, ox, H, W, nf;
  __device__ __forceinline__ void operator()(int sy, int sx, int c, float v0, float v1) const {
    const int gy = oy + sy, gx = ox + sx;
    if (gy >= H || gx >= W) return;
    const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(feat + (sy * pw + sx) * cp + c);
    float r0 = __low2float(xv) + 0.2f * (v0 + b[c]);
    float r1 = __high2float(xv) + 0.2f * (v1 + b[c + 1]);
    const size_t o = (img + (size_t)gy * W + gx) * nf + c;
    if (x0 != nullptr) {
      const __nv_bfloat162 z = *reinterpret_cast<const __nv_bfloat162*>(x0 + o);
      r0 = __low2float(z) + 0.2f * r0;
      r1 = __high2float(z) + 0.2f * r1;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(r0, r1);
  }
};

__global__ void __launch_bounds__(kThreads)
    rdb_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ x0, bf16* __restrict__ out,
                        bf16* __restrict__ saved, const uint4* __restrict__ w, const float* __restrict__ b, int H,
                        int W, int nf, int gc, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* feat = reinterpret_cast<bf16*>(smem_raw);
  const int ph = th + 2 * kHalo, pw = tw + 2 * kHalo, cp = nf + 4 * gc + kPad;
  const int oy = blockIdx.y * th - kHalo;  // image coordinates of buffer pixel (0, 0)
  const int ox = blockIdx.x * tw - kHalo;
  const size_t img = (size_t)blockIdx.z * H * W;

  // x with its halo, 8 channels (16 bytes) at a time; zero outside the image
  const int vecs = nf / 8;
  for (int i = threadIdx.x; i < ph * pw * vecs; i += kThreads) {
    const int v = i % vecs, pix = i / vecs;
    const int gy = oy + pix / pw, gx = ox + pix % pw;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = *reinterpret_cast<const uint4*>(x + (img + (size_t)gy * W + gx) * nf + v * 8);
    *reinterpret_cast<uint4*>(feat + pix * cp + v * 8) = val;
  }
  __syncthreads();

  const uint4* wk = w;
  for (int k = 0; k < 4; ++k) {
    const int cin = nf + k * gc;
    const GrowthStore epi{feat, b + k * gc, cp, pw, cin, oy, ox, H, W};
    conv3x3_mma(feat, cp, pw, 1 + k, ph - 2 - 2 * k, pw - 2 - 2 * k, cin, gc, wk, epi);
    wk += (size_t)(gc / 16) * (9 * cin / 16) * 32;
    __syncthreads();
  }
  if (saved != nullptr) {  // B1: the tile's [x, h_1 .. h_4] to device memory, 16 bytes at a time
    const int total = nf + 4 * gc, tv = total / 8;
    for (int i = threadIdx.x; i < th * tw * tv; i += kThreads) {
      const int v = i % tv, pix = i / tv, sy = pix / tw, sx = pix % tw;
      const int gy = oy + kHalo + sy, gx = ox + kHalo + sx;
      if (gy < H && gx < W)
        *reinterpret_cast<uint4*>(saved + (img + (size_t)gy * W + gx) * total + v * 8) =
            *reinterpret_cast<const uint4*>(feat + ((kHalo + sy) * pw + kHalo + sx) * cp + v * 8);
    }
  }
  const ResidualStore epi{feat, x0, out, b + 4 * gc, img, cp, pw, oy, ox, H, W, nf};
  conv3x3_mma(feat, cp, pw, kHalo, th, tw, nf + 4 * gc, nf, wk, epi);
}

// ---------------------------------------------------------------- float32, CUDA cores

__global__ void __launch_bounds__(kThreads)
    rdb_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ x0, float* __restrict__ out,
                       float* __restrict__ saved, const float* __restrict__ w, const float* __restrict__ b, int H,
                       int W, int nf, int gc, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* feat = reinterpret_cast<float*>(smem_raw);  // channel-major planes
  const int ph = th + 2 * kHalo, pw = tw + 2 * kHalo, plane = ph * pw;
  const int oy = blockIdx.y * th - kHalo;
  const int ox = blockIdx.x * tw - kHalo;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.x;

  for (int i = tid; i < plane * nf; i += kThreads) {
    const int c = i % nf, pix = i / nf;
    const int gy = oy + pix / pw, gx = ox + pix % pw;
    feat[c * plane + pix] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W) ? x[(img + (size_t)gy * W + gx) * nf + c] : 0.f;
  }
  __syncthreads();

  const float* wk = w;
  for (int k = 0; k < 4; ++k) {
    const int cin = nf + k * gc;
    const int r0 = 1 + k;
    const int rh = ph - 2 - 2 * k, rw = pw - 2 - 2 * k;
    const int pairs_x = rw / kP, npairs = rh * pairs_x;
    for (int it = tid; it < npairs * (gc / kQ); it += kThreads) {
      const int g = it / npairs, pr = it % npairs;
      const int sy = r0 + pr / pairs_x, sx = r0 + (pr % pairs_x) * kP;
      float acc[kP][kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
#pragma unroll
        for (int p = 0; p < kP; ++p) acc[p][q] = b[k * gc + g * kQ + q];
      conv3x3_fma(acc, feat, cin, plane, pw, wk + g * kQ, gc, sy, sx);
      const int gy = oy + sy;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int gx = ox + sx + p;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        float* dst = feat + (size_t)(cin + g * kQ) * plane + sy * pw + sx + p;
#pragma unroll
        for (int q = 0; q < kQ; ++q) dst[q * plane] = inside ? (acc[p][q] > 0.f ? acc[p][q] : 0.2f * acc[p][q]) : 0.f;
      }
    }
    wk += (size_t)9 * cin * gc;
    __syncthreads();
  }
  if (saved != nullptr) {  // B1: the tile's [x, h_1 .. h_4] to device memory
    const int total = nf + 4 * gc;
    for (int i = tid; i < th * tw * total; i += kThreads) {
      const int c = i % total, pix = i / total, sy = pix / tw, sx = pix % tw;
      const int gy = oy + kHalo + sy, gx = ox + kHalo + sx;
      if (gy < H && gx < W)
        saved[(img + (size_t)gy * W + gx) * total + c] = feat[(size_t)c * plane + (kHalo + sy) * pw + kHalo + sx];
    }
  }

  const int pairs_x = tw / kP, npairs = th * pairs_x;
  for (int it = tid; it < npairs * (nf / kQ); it += kThreads) {
    const int g = it / npairs, pr = it % npairs;
    const int sy = kHalo + pr / pairs_x, sx = kHalo + (pr % pairs_x) * kP;
    float acc[kP][kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int p = 0; p < kP; ++p) acc[p][q] = b[4 * gc + g * kQ + q];
    conv3x3_fma(acc, feat, nf + 4 * gc, plane, pw, wk + g * kQ, nf, sy, sx);
    const int gy = oy + sy;
    if (gy >= H) continue;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int gx = ox + sx + p;
      if (gx >= W) continue;
      const size_t o = (img + (size_t)gy * W + gx) * nf + g * kQ;
      const float* xs = feat + (size_t)(g * kQ) * plane + sy * pw + sx + p;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float r = xs[q * plane] + 0.2f * acc[p][q];
        if (x0 != nullptr) r = x0[o + q] + 0.2f * r;
        out[o + q] = r;
      }
    }
  }
}

template <class Kernel, class T, class Wt>
int launch(Kernel kernel, size_t smem, const void* x, const void* x0, void* out, void* saved, const void* w,
           const void* b, int n, int h, int w_, int nf, int gc, int th, int tw, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w_ + tw - 1) / tw, (h + th - 1) / th, n);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(x0), static_cast<T*>(out),
                                           static_cast<T*>(saved), static_cast<const Wt*>(w),
                                           static_cast<const float*>(b), h, w_, nf, gc, th, tw);
  return (int)cudaGetLastError();
}

int forward(const void* x, const void* x0, void* out, void* saved, const void* w, const void* b, int n, int h,
            int w_, int nf, int gc, int th, int tw, int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w_ < 1 || th < 1 || tw < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (nf % 16 || gc % 16) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(th + 2 * kHalo) * (tw + 2 * kHalo) * (nf + 4 * gc + kPad) * sizeof(bf16);
    return launch<decltype(&rdb_fwd_bf16_kernel), bf16, uint4>(&rdb_fwd_bf16_kernel, smem, x, x0, out, saved, w, b,
                                                               n, h, w_, nf, gc, th, tw, s);
  }
  if (nf % kQ || gc % kQ || tw % kP) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(nf + 4 * gc) * (th + 2 * kHalo) * (tw + 2 * kHalo) * sizeof(float);
  return launch<decltype(&rdb_fwd_f32_kernel), float, float>(&rdb_fwd_f32_kernel, smem, x, x0, out, saved, w, b, n,
                                                             h, w_, nf, gc, th, tw, s);
}

}  // namespace

// Plain C entry points (bound with ctypes). `w` is the wrapper's packing for
// the dtype: bf16 fragment order (is_bf16) or f32 tap-major. Each returns a
// cudaError_t value; 0 is success.
//
// Kernel A: the forward.
extern "C" int climsr_rdb_fwd(const void* x, const void* x0, void* out, const void* w, const void* b, int n,
                              int h, int w_, int nf, int gc, int th, int tw, int is_bf16, void* stream) {
  return forward(x, x0, out, nullptr, w, b, n, h, w_, nf, gc, th, tw, is_bf16, stream);
}

// Kernel B1: the forward that also writes feat (N x H x W x (nf + 4*gc)).
extern "C" int climsr_rdb_fwd_save(const void* x, const void* x0, void* out, void* feat, const void* w,
                                   const void* b, int n, int h, int w_, int nf, int gc, int th, int tw, int is_bf16,
                                   void* stream) {
  if (feat == nullptr) return (int)cudaErrorInvalidValue;
  return forward(x, x0, out, feat, w, b, n, h, w_, nf, gc, th, tw, is_bf16, stream);
}
