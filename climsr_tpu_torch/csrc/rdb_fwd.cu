// Fused residual-dense-block forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rdb_t_kernel` / `_rdb_t_forward_body`
// (climsr_tpu/ops/pallas/rdb.py:190, :326). One launch computes one RDB:
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
// Bound on this card: at the main path's shape (16 tiles of 128 x 128, nf=64,
// gc=16, bf16) one launch needs 65.2 GFLOP against 100 MB of traffic, so it is
// bound by operations (66 us at the tensor cores' dense bf16 rate, 30 us of
// memory). The design keeps every intermediate on chip, so the traffic stays
// at x, x0 and out; what it pays instead is the halo recompute (~1.27x the
// useful MACs at 16 x 16 tiles) and mma.sync instead of wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalo = 5;  // one pixel for each of the five convs
constexpr int kPad = 8;   // bf16 buffer: channels per pixel = nf + 4*gc + kPad
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bfloat16, tensor cores

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// One conv3x3 over a rh x rw region (origin (r0, r0) in buffer coordinates)
// as an implicit GEMM: M = the region's pixels, N = cout, K = 9 * cin. `w`
// holds the conv's weights in fragment order: for each group q of 16 output
// channels and each k-step s (16 of K = tap * cin + ci), 32 lanes x 16 bytes.
template <class Epilogue>
__device__ __forceinline__ void conv3x3_mma(const bf16* feat, int cp, int pw, int r0, int rh, int rw, int cin,
                                            int cout, const uint4* __restrict__ w, const Epilogue& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int npix = rh * rw, mgroups = (npix + 31) / 32, csteps = cin / 16, ksteps = 9 * csteps;
  const int items = mgroups * (cout / 16);
  for (int item = warp; item < items; item += kWarps) {
    const int q = item / mgroups, mg = item % mgroups;
    // the buffer row this lane feeds to ldmatrix, for each of the two M-tiles
    int base[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      int m = mg * 32 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      if (m >= npix) m = 0;  // rows past the region: any valid pixel, result dropped
      base[mt] = ((r0 + m / rw) * pw + r0 + m % rw) * cp + (lane >> 4) * 8;
    }
    float acc[2][2][4] = {};
    const uint4* wq = w + (size_t)q * ksteps * 32 + lane;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = ((tap / 3 - 1) * pw + (tap % 3 - 1)) * cp;
#pragma unroll 2
      for (int c = 0; c < csteps; ++c) {
        const uint4 bw = __ldg(wq);
        wq += 32;
        unsigned a[2][4];
        ldmatrix_x4(a[0], feat + base[0] + off + c * 16);
        ldmatrix_x4(a[1], feat + base[1] + off + c * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][0], a[mt], bw.x, bw.y);
          mma_bf16(acc[mt][1], a[mt], bw.z, bw.w);
        }
      }
    }
    // accumulator rows g and g + 8 of each M-tile, channels 2t, 2t + 1 of each n-tile
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mg * 32 + mt * 16 + g + 8 * half;
        if (m >= npix) continue;
        const int sy = r0 + m / rw, sx = r0 + m % rw;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          epi(sy, sx, q * 16 + nt * 8 + 2 * t, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
  }
}

__global__ void __launch_bounds__(kThreads)
    rdb_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ x0, bf16* __restrict__ out,
                        const uint4* __restrict__ w, const float* __restrict__ b, int H, int W, int nf, int gc,
                        int th, int tw) {
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
  const ResidualStore epi{feat, x0, out, b + 4 * gc, img, cp, pw, oy, ox, H, W, nf};
  conv3x3_mma(feat, cp, pw, kHalo, th, tw, nf + 4 * gc, nf, wk, epi);
}

// ---------------------------------------------------------------- float32, CUDA cores

constexpr int kQ = 8;  // output channels per work item
constexpr int kP = 2;  // horizontally adjacent pixels per work item

// acc[p][q] += sum over the 3x3 taps and `cin` buffer channels around buffer
// pixel (sy, sx + p) for output channel q. `w` points at this work item's
// first output channel inside one conv's tap-major weights ([tap][cin][cout]).
__device__ __forceinline__ void conv3x3_fma(float (&acc)[kP][kQ], const float* __restrict__ feat, int cin,
                                            int plane, int pw, const float* __restrict__ w, int cout, int sy,
                                            int sx) {
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const float* f = feat + (sy + tap / 3 - 1) * pw + (sx + tap % 3 - 1);
    const float* wt = w + (size_t)tap * cin * cout;
#pragma unroll 4
    for (int ci = 0; ci < cin; ++ci) {
      const float4 wa = __ldg(reinterpret_cast<const float4*>(wt + (size_t)ci * cout));
      const float4 wb = __ldg(reinterpret_cast<const float4*>(wt + (size_t)ci * cout) + 1);
      const float wq[kQ] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int p = 0; p < kP; ++p)
#pragma unroll
        for (int q = 0; q < kQ; ++q) acc[p][q] = fmaf(f[ci * plane + p], wq[q], acc[p][q]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    rdb_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ x0, float* __restrict__ out,
                       const float* __restrict__ w, const float* __restrict__ b, int H, int W, int nf, int gc,
                       int th, int tw) {
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
int launch(Kernel kernel, size_t smem, const void* x, const void* x0, void* out, const void* w, const void* b,
           int n, int h, int w_, int nf, int gc, int th, int tw, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w_ + tw - 1) / tw, (h + th - 1) / th, n);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(x0), static_cast<T*>(out),
                                           static_cast<const Wt*>(w), static_cast<const float*>(b), h, w_, nf, gc,
                                           th, tw);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). `w` is the wrapper's packing for the
// dtype: bf16 fragment order (is_bf16) or f32 tap-major. Returns a cudaError_t
// value; 0 is success.
extern "C" int climsr_rdb_fwd(const void* x, const void* x0, void* out, const void* w, const void* b, int n,
                              int h, int w_, int nf, int gc, int th, int tw, int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w_ < 1 || th < 1 || tw < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (nf % 16 || gc % 16) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(th + 2 * kHalo) * (tw + 2 * kHalo) * (nf + 4 * gc + kPad) * sizeof(bf16);
    return launch<decltype(&rdb_fwd_bf16_kernel), bf16, uint4>(&rdb_fwd_bf16_kernel, smem, x, x0, out, w, b, n, h,
                                                               w_, nf, gc, th, tw, s);
  }
  if (nf % kQ || gc % kQ || tw % kP) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(nf + 4 * gc) * (th + 2 * kHalo) * (tw + 2 * kHalo) * sizeof(float);
  return launch<decltype(&rdb_fwd_f32_kernel), float, float>(&rdb_fwd_f32_kernel, smem, x, x0, out, w, b, n, h, w_,
                                                             nf, gc, th, tw, s);
}
