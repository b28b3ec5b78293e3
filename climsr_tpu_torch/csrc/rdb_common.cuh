// Shared pieces of the residual-dense-block kernels (rdb_fwd.cu, rdb_bwd.cu).
//
// The forward (kernels A and B1) and the input-gradient half of the backward
// (kernel B2) are the same shape of computation: a chain of five 3x3 convs
// over a feature buffer in shared memory that grows by gc channels per conv,
// each conv over a region one pixel smaller than the last. They differ only in
// what is loaded first and in each conv's epilogue, so the conv itself lives
// here: `conv3x3_mma` (bf16, tensor cores) and `conv3x3_fma` (f32, CUDA
// cores).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace rdb {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalo = 5;  // one pixel for each of the five convs
constexpr int kPad = 8;   // bf16 buffer: channels per pixel = nf + 4*gc + kPad
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// the same, each 8 x 8 matrix transposed on the way into the registers
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// One conv3x3 over a rh x rw region (origin (r0, r0) in buffer coordinates)
// as an implicit GEMM: M = the region's pixels, N = cout, K = 9 * cin. The
// buffer is pixel-major with cp channels per pixel and pw pixels per row. `w`
// holds the conv's weights in fragment order: for each group q of 16 output
// channels and each k-step s (16 of K = tap * cin + ci), 32 lanes x 16 bytes.
// The epilogue gets (buffer y, buffer x, channel c, value c, value c + 1).
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

constexpr int kQ = 8;  // f32 path: output channels per work item
constexpr int kP = 2;  // f32 path: horizontally adjacent pixels per work item

// acc[p][q] += sum over the 3x3 taps and `cin` buffer channels around buffer
// pixel (sy, sx + p) for output channel q. The f32 buffer is channel-major
// (planes of `plane` pixels, pw per row). `w` points at this work item's first
// output channel inside one conv's tap-major weights ([tap][cin][cout]).
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

}  // namespace rdb
