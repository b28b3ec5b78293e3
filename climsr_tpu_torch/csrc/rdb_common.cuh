// Shared pieces of the residual-dense-block kernels (rdb_fwd.cu, rdb_bwd.cu)
// and of kernels C and E (conv9_dx_c0.cu, hr_tail.cu; kernel F's entry point
// launches C's kernel).
//
// The forward (kernels A and B1) and the input-gradient half of the backward
// (kernel B2) are the same shape of computation: a chain of five 3x3 convs
// over a feature buffer in shared memory that grows by gc channels per conv,
// each conv over a region one pixel smaller than the last. They differ only in
// what is loaded first and in each conv's epilogue, so the chain itself lives
// here: `conv_chain` (bf16, tensor cores, weights streamed through a
// shared-memory ring; nf a multiple of 16 up to 128 and gc = 16, 32 or 48,
// the tile chosen by the wrapper from the shared-memory budget) and
// `conv3x3_fma` (f32, CUDA cores, one conv, any widths). Below
// them are the instructions every bf16 kernel builds on: cp.async copies,
// ldmatrix, mma.sync m16n8k16 and wgmma m64nNk16 (N = 16, 32, 48, 64) with
// its shared-memory descriptor. Kernel E (hr_tail.cu) runs its 64 -> 64 HRconv the way
// `conv_chain` runs its last conv (wgmma, B from shared memory in the same
// K-major layout), with all of HRconv's weights resident in shared memory;
// kernel C (conv9_dx_c0.cu) runs mma.sync over a ring of staged rows.
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

// Phase clocks, compiled in only with -DCLIMSR_PHASE_CLOCKS (for
// climsr_tpu_torch/scripts/rdb_phase_clocks.py): thread 0 of each block
// writes clock64() at kPhases points of the chain into
// g_phase_clocks[block][kPhases], when the pointer is set.
constexpr int kPhases = 8;
#ifdef CLIMSR_PHASE_CLOCKS
__device__ long long* g_phase_clocks;
__device__ __forceinline__ void phase_clock(int i) {
  if (g_phase_clocks != nullptr && threadIdx.x == 0)
    g_phase_clocks[((size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * kPhases + i] =
        clock64();
}
#else
__device__ __forceinline__ void phase_clock(int) {}
#endif

// 16 bytes global -> shared without passing through registers (cp.async,
// sm_80 and later); zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// this thread's copies have landed; a __syncthreads() after it makes everyone's visible
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

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

// Warpgroup products (wgmma, sm_90a): a warpgroup is 4 consecutive warps.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor without swizzle: 8-row x 16-byte core
// matrices, `lbo` bytes apart along K, `sbo` bytes apart along M or N.
__device__ __forceinline__ unsigned long long smem_desc(const void* p, unsigned lbo, unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return (unsigned long long)((a & 0x3FFFF) >> 4) | ((unsigned long long)(lbo >> 4) << 16) |
         ((unsigned long long)(sbo >> 4) << 32);
}

// d (64 x N f32) += a (64 x 16 bf16 from registers: each warp of the
// warpgroup holds its 16 rows as mma.m16n8k16's A fragment) * B (16 x N
// bf16 in shared memory, K-major, descriptor b). Thread layout of d: n-tile
// j (8 columns) is d[4j .. 4j + 3], as mma.m16n8k16's C fragment. One
// specialisation per N the chain's last conv uses (its passes of at most 64
// outputs, `kLastN`).
template <int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], const unsigned (&a)[4], unsigned long long b);

template <>
__device__ __forceinline__ void wgmma_m64k16<16>(float (&d)[8], const unsigned (&a)[4], unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16<32>(float (&d)[16], const unsigned (&a)[4], unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16<48>(float (&d)[24], const unsigned (&a)[4], unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16<64>(float (&d)[32], const unsigned (&a)[4], unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- the bf16 conv chain, weights through a ring

// The chain's weights arrive packed conv after conv, k-step (ci group of 16,
// tap) after k-step, ci group outermost. A growth conv's k-step is
// [gc / 16][32 lanes][8 bf16], the lanes holding mma.m16n8k16's B fragments
// for each block of 16 outputs (ops/rdb.py `fragment_index`). The last conv
// runs in passes of at most kLastN outputs (one at nf <= 64, two at
// 64 < nf <= 128), each streamed whole before the next; a pass's k-step is
// wgmma's K-major B tile of 16 k x N outputs (N = the pass's outputs)
// without swizzle: core matrices of 8 outputs x 8 k (128 contiguous bytes,
// one output per 16-byte row), core matrix (output block b, k half h) at
// (2b + h) * 128 bytes. A chunk is kSlotCols / cout consecutive ci groups of
// one conv or pass (4 of a growth conv at gc = 16, 2 at gc = 32, 1 at
// gc = 48; 1 of a 64-output pass, 2 of a 32-output one), one ring slot.
constexpr int kSlotCols = 64;
constexpr int kSlotElems = 9 * 16 * kSlotCols;  // 18,432 bytes
constexpr int kRingBytes = 2 * kSlotElems * 2;  // two slots
constexpr int kGrowthMT = 5;  // growth conv: 16-pixel M-tiles per warp (36 in conv 1 at 16 x 16 tiles)
constexpr int kMaxGrowthQ = 3;  // growth conv: 16-output blocks (gc / 16) the engine is built for
constexpr int kLastMT = 2;    // last conv: 64-pixel M-blocks per warpgroup (4 at 16 x 16 tiles)
constexpr int kLastN = 64;    // last conv: outputs per pass, wgmma's N at most
constexpr int kMaxNf = 2 * kLastN;  // nf the chain takes: a multiple of 16 up to two passes

// The shapes conv_chain takes: nf a multiple of 16 up to kMaxNf, gc a
// multiple of 16 up to 16 * kMaxGrowthQ, and tiles small enough that each
// conv's M-tiles fit the warps' share.
inline bool chain_fits(int nf, int gc, int th, int tw) {
  return nf % 16 == 0 && nf >= 16 && nf <= kMaxNf && gc % 16 == 0 && gc >= 16 && gc <= 16 * kMaxGrowthQ &&
         th >= 1 && tw >= 1 &&
         th <= 16 && tw <= 16 && (th + 8) * (tw + 8) <= 16 * kWarps * kGrowthMT &&
         th * tw <= 16 * kWarps * kLastMT;
}

// Shared memory of a chain kernel: the ring (at the start: wgmma reads it),
// then the feature buffer.
inline size_t chain_smem(int nf, int gc, int th, int tw) {
  return kRingBytes + (size_t)(th + 2 * kHalo) * (tw + 2 * kHalo) * (nf + 4 * gc + kPad) * sizeof(bf16);
}

// Copies the chain's chunks, in order, into ring slots. Every thread holds
// the same state; all of them call `fetch` together. Stream conv c is growth
// conv c for c < 4, then pass c - 4 of the last conv (outputs
// kLastN * (c - 4) onwards).
struct WeightStream {
  const bf16* w;
  int nf, gc;
  int c = 0, k = 0;  // the next chunk: chunk k of stream conv c
  size_t off = 0;    // its first element in w
  __device__ __forceinline__ int groups(int cc) const { return (nf + min(cc, 4) * gc) / 16; }
  __device__ __forceinline__ int cout(int cc) const { return cc < 4 ? gc : min(kLastN, nf - kLastN * (cc - 4)); }
  __device__ __forceinline__ int per_chunk(int cc) const { return kSlotCols / cout(cc); }
  __device__ __forceinline__ void fetch(bf16* slot) {
    if (c == 4 + (nf + kLastN - 1) / kLastN) return;  // past the last chunk
    const int per = per_chunk(c), ng = min(per, groups(c) - k * per);
    const int vecs = ng * 9 * 2 * cout(c);  // 16-byte vectors: ng * 9 * 16 * cout / 8
    for (int i = threadIdx.x; i < vecs; i += kThreads) cp_async16(slot + 8 * i, w + off + 8 * i, true);
    off += (size_t)vecs * 8;
    if (++k * per >= groups(c)) {
      ++c;
      k = 0;
    }
  }
};

// Chunk j of the chain is due: wait for it (slot j & 1) and every earlier
// copy, make the copies visible to wgmma (the async proxy), then start chunk
// j + 1 into the other slot, which every warp has finished reading (chunk
// j - 1) once all have passed the barrier. Returns slot j & 1.
__device__ __forceinline__ const bf16* ring_next(WeightStream& ws, bf16* ring, int j) {
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  ws.fetch(ring + ((j + 1) & 1) * kSlotElems);
  cp_async_commit();
  return ring + (j & 1) * kSlotElems;
}

// One growth conv's products for a warp that holds MT M-tiles, every k-step
// of conv c streamed through the ring (chunks j, j + 1, ..). A k-step holds
// NQ = gc / 16 blocks of 16 outputs, each lane's B fragments of block q one
// 16-byte vector at (k-step * NQ + q) * 32 + lane; one A fragment feeds all
// 2 * NQ n-tiles. Every warp of the block holds the same MT: an M-tile past
// the region computes on a clamped pixel and is dropped, so the loop has no
// branch and the loads of one tap can run ahead of the products of the last.
template <int MT, int NQ>
__device__ __forceinline__ void growth_products(float (&acc)[kGrowthMT][2 * NQ][4], const bf16* feat,
                                                const int (&base)[kGrowthMT], WeightStream& ws, bf16* ring, int& j,
                                                int c, int pw, int cp) {
  const int groups = ws.groups(c), per = ws.per_chunk(c);
  for (int k = 0; k * per < groups; ++k, ++j) {
    const uint4* slot = reinterpret_cast<const uint4*>(ring_next(ws, ring, j)) + (threadIdx.x & 31);
    if (j == 0) phase_clock(1);  // the buffer's loads and the first chunk have landed
    const int ng = min(per, groups - k * per);
#pragma unroll 1
    for (int gl = 0; gl < ng; ++gl) {
      const int ch = (k * per + gl) * 16;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint4 b[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) b[q] = slot[((gl * 9 + tap) * NQ + q) * 32];
        const int off = ((tap / 3 - 1) * pw + tap % 3 - 1) * cp + ch;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          unsigned a[4];
          ldmatrix_x4(a, feat + base[i] + off);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            mma_bf16(acc[i][2 * q], a, b[q].x, b[q].y);
            mma_bf16(acc[i][2 * q + 1], a, b[q].z, b[q].w);
          }
        }
      }
    }
  }
}

// The four growth convs of conv_chain (below) for gc = 16 * NQ.
template <int NQ, class Growth>
__device__ __forceinline__ void growth_convs(const bf16* feat, WeightStream& ws, bf16* ring, int& j, int pw, int th,
                                             int tw, int cp, const Growth& growth) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // accumulator rows g, g + 8; columns 2t, 2t + 1
  for (int c = 0; c < 4; ++c) {
    const int r0 = 1 + c, rh = th + 2 * kHalo - 2 - 2 * c, rw = tw + 2 * kHalo - 2 - 2 * c;
    const int npix = rh * rw, mtiles = (npix + 15) / 16;
    int base[kGrowthMT];  // the buffer element this lane feeds to ldmatrix, for each M-tile
#pragma unroll
    for (int i = 0; i < kGrowthMT; ++i) {
      int m = (warp + kWarps * i) * 16 + (lane & 15);
      if (m >= npix) m = 0;  // rows past the region: any valid pixel, result dropped
      base[i] = ((r0 + m / rw) * pw + r0 + m % rw) * cp + (lane >> 4) * 8;
    }
    float acc[kGrowthMT][2 * NQ][4] = {};
    switch ((mtiles + kWarps - 1) / kWarps) {  // M-tiles per warp, the same for the whole block
      case 1: growth_products<1, NQ>(acc, feat, base, ws, ring, j, c, pw, cp); break;
      case 2: growth_products<2, NQ>(acc, feat, base, ws, ring, j, c, pw, cp); break;
      case 3: growth_products<3, NQ>(acc, feat, base, ws, ring, j, c, pw, cp); break;
      case 4: growth_products<4, NQ>(acc, feat, base, ws, ring, j, c, pw, cp); break;
      default: growth_products<5, NQ>(acc, feat, base, ws, ring, j, c, pw, cp); break;
    }
#pragma unroll
    for (int i = 0; i < kGrowthMT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (warp + kWarps * i) * 16 + g + 8 * half;
        if (m >= npix) continue;
#pragma unroll
        for (int nt = 0; nt < 2 * NQ; ++nt)
          growth(c, r0 + m / rw, r0 + m % rw, nt * 8 + 2 * t, acc[i][nt][2 * half], acc[i][nt][2 * half + 1]);
      }
    phase_clock(2 + c);
  }
}

// One pass of the last conv: outputs n0 .. n0 + N - 1 (stream conv c) over
// the tile, all nf + 4*gc input channels, on wgmma m64nNk16. M-tiles warp and
// warp + 8 of the four warps of a warpgroup are two 64-pixel M-blocks, A
// comes from registers (ldmatrix, so a tap stays an address offset) and B
// straight from the ring slot, and one A fragment feeds all N outputs; the
// sums go to last(y, x, channel, v0, v1). between() runs before the first
// pass's products.
template <int N, class Last, class Between>
__device__ __forceinline__ void last_pass(const bf16* feat, WeightStream& ws, bf16* ring, int& j, int c, int n0,
                                          int pw, int th, int tw, int cp, const Last& last,
                                          const Between& between) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // accumulator rows g, g + 8; columns 2t, 2t + 1
  const int npix = th * tw, mtiles = (npix + 15) / 16;
  int base[kLastMT];
  bool block[kLastMT];  // M-block i of this warpgroup holds a pixel (the same for its four warps)
#pragma unroll
  for (int i = 0; i < kLastMT; ++i) {
    int m = (warp + kWarps * i) * 16 + (lane & 15);
    if (m >= npix) m = 0;
    base[i] = ((kHalo + m / tw) * pw + kHalo + m % tw) * cp + (lane >> 4) * 8;
    block[i] = (warp & ~3) + kWarps * i < mtiles;
  }
  float acc[kLastMT][N / 2] = {};
  const int groups = ws.groups(c), per = ws.per_chunk(c);
  for (int k = 0; k * per < groups; ++k, ++j) {
    const bf16* slot = ring_next(ws, ring, j);
    if (n0 == 0 && k == 0) between();
    const int ng = min(per, groups - k * per);
#pragma unroll 1
    for (int gl = 0; gl < ng; ++gl) {
      const int ch = (k * per + gl) * 16;
      unsigned a[2][kLastMT][4];  // two sets: the next tap's loads while this tap's products run
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = ((tap / 3 - 1) * pw + tap % 3 - 1) * cp + ch;
#pragma unroll
        for (int i = 0; i < kLastMT; ++i)
          if (block[i]) ldmatrix_x4(a[tap & 1][i], feat + base[i] + off);
        wgmma_fence();
        const unsigned long long b = smem_desc(slot + (gl * 9 + tap) * 16 * N, 128, 256);
#pragma unroll
        for (int i = 0; i < kLastMT; ++i)
          if (block[i]) wgmma_m64k16<N>(acc[i], a[tap & 1][i], b);
        wgmma_commit();
        wgmma_wait<1>();  // the last tap's products are done: its A registers are free
      }
      wgmma_wait<0>();  // before the next ci group (or chunk) starts over with set 0
    }
  }
  phase_clock(6);
#pragma unroll
  for (int i = 0; i < kLastMT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (warp + kWarps * i) * 16 + g + 8 * half;
      if (m >= npix) continue;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        last(kHalo + m / tw, kHalo + m % tw, n0 + nt * 8 + 2 * t, acc[i][4 * nt + 2 * half],
             acc[i][4 * nt + 2 * half + 1]);
    }
  phase_clock(7);
}

// The five 3x3 convs of an RDB chain, bf16 on the tensor cores with f32
// sums, over the pixel-major buffer `feat` (cp = nf + 4*gc + kPad channels
// per pixel, pw pixels per row, the th x tw tile at (kHalo, kHalo)). Growth
// conv c (0..3, gc outputs) reads channels [0, nf + c*gc) over the
// region one pixel smaller on every side than conv c - 1's (conv 0: the
// buffer less one pixel) and hands each pair of sums to growth(c, buffer y,
// buffer x, channel, v0, v1), which stores it for the next conv. The last conv
// (nf outputs) reads all nf + 4*gc channels over the tile and hands its
// sums to last(y, x, channel, v0, v1). between() runs once every growth
// output is in the buffer, before the last conv's products. The caller has
// started its buffer loads (plain stores or cp.async, not yet committed); the
// first barrier here covers them. chain_fits() holds.
//
// The weights stream through `ring` (two kSlotElems slots) one chunk ahead
// of the products, so device memory (L2) is read once per block and conv.
// A warp owns M-tiles (16 pixels) warp, warp + 8, ... of each conv; its
// accumulators stay in registers across the chunks. Growth convs run on
// mma.sync m16n8k16: one A fragment (ldmatrix from the buffer) feeds all
// gc / 8 n-tiles of 8 outputs (2 at gc = 16, 4 at gc = 32). The last conv
// runs on wgmma (`last_pass`) in passes of at most kLastN = 64 outputs: one
// of nf outputs at nf <= 64 (N = 16, 32, 48 or 64), two at 64 < nf <= 128
// (64, then nf - 64), each re-reading the buffer's A fragments, so the
// accumulators stay at 32 registers per M-block and the ring's slots at
// 64 columns whatever nf is. NQ = gc / 16 is a template parameter, so each
// growth width is a kernel of its own: gc = 16's code and registers do not
// depend on the wider ones'. So is ANY_NF: the kernels for nf = 64 (false)
// hold only the 64-output pass, those for every other nf (true) the passes of
// 16, 32, 48 and 64 outputs behind a switch, so nf = 64's code is not changed
// by the other widths'.
template <int NQ, bool ANY_NF, class Growth, class Last, class Between>
__device__ __forceinline__ void conv_chain(const bf16* feat, bf16* ring, const bf16* __restrict__ w, int nf,
                                           int gc, int pw, int th, int tw, const Growth& growth, const Last& last,
                                           const Between& between) {
  const int cp = nf + 4 * gc + kPad;
  WeightStream ws{w, nf, gc};
  ws.fetch(ring);
  cp_async_commit();
  int j = 0;  // chunks consumed

  growth_convs<NQ>(feat, ws, ring, j, pw, th, tw, cp, growth);

  if constexpr (!ANY_NF) {
    last_pass<kLastN>(feat, ws, ring, j, 4, 0, pw, th, tw, cp, last, between);  // nf = 64: one pass
  } else {
    for (int c = 4, n0 = 0; n0 < nf; ++c, n0 += kLastN) {
      switch (min(kLastN, nf - n0)) {
        case 16: last_pass<16>(feat, ws, ring, j, c, n0, pw, th, tw, cp, last, between); break;
        case 32: last_pass<32>(feat, ws, ring, j, c, n0, pw, th, tw, cp, last, between); break;
        case 48: last_pass<48>(feat, ws, ring, j, c, n0, pw, th, tw, cp, last, between); break;
        default: last_pass<64>(feat, ws, ring, j, c, n0, pw, th, tw, cp, last, between); break;
      }
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
