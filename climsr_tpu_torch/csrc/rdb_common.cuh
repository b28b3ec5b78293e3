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
// shared-memory ring, growth convs source-major; nf a multiple of 16 up to
// 128 and gc = 16, 32 or 48, the tile and the growth depth chosen by the
// wrapper from the shared-memory budget and the ring's slot) and
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

// the same from a shared-memory byte address (32 bits: a register a row, not a generic pointer's two)
__device__ __forceinline__ void ldmatrix_x4_at(unsigned (&r)[4], unsigned a) {
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

// Growth conv c (0..3) reads the source slices x and h_1 .. h_c of the
// buffer, and its sum splits by slice. The chain runs the growth convs
// source-major, in groups of D (the growth depth, the wrapper's
// `growth_depth`): group a is convs a .. a + D - 1, laid out over region a
// (conv a's pixels, the largest of the group), and step c (0..3) multiplies
// one part of the buffer into the sums of convs c .. a + D - 1: channels
// [0, nf + c*gc) at the group's first step (x and every slice an earlier
// group finished), h_c's gc channels at the others. One ldmatrix of a
// 16-channel group, tap and M-tile feeds every pending conv that needs that
// M-tile; an M-tile outside a conv's region skips its products, so each
// slice is read over the region of the first conv that uses it. After step c
// conv c's sums are complete and its epilogue runs; h_{c+1} is in the buffer
// for the steps after it. D = 1 is one conv at a time over its own region.
//
// What it saves against one conv at a time: A fragments read from shared
// memory, per warp and tile, 477 ldmatrix (x4) where the per-conv step reads
// 765 at gc = 16 on 16 x 16 tiles (the slices' pixel-channels 90,880 against
// 150,272, 9 taps each), 342 against 594 at gc = 32 on 8 x 16 (75,264
// against 113,664); both at depth 2. The products grow by the rows a group's
// region has beyond its later conv's (1746 mma.sync a warp against 1530 at
// gc = 16; 2376 both at gc = 32). The pending sums are D * gc / 2 f32
// registers a thread per M-tile: 80 at gc = 16 (5 M-tiles), 96 at gc = 32
// (3). gc = 48 keeps the per-conv step.
//
// The chain's weights arrive packed step after step, then the last conv's
// passes, k-step (16-channel group, tap) after k-step, channel group
// outermost. A growth step's k-step is [pending convs][gc / 16][32 lanes][8
// bf16], the lanes holding mma.m16n8k16's B fragments for each block of 16
// outputs (ops/rdb.py `fragment_index`, `growth_steps`). The last conv runs in
// passes of at most kLastN outputs (one at nf <= 64, two at 64 < nf <= 128),
// each streamed whole before the next; a pass's k-step is wgmma's K-major B
// tile of 16 k x N outputs (N = the pass's outputs) without swizzle: core
// matrices of 8 outputs x 8 k (128 contiguous bytes, one output per 16-byte
// row), core matrix (output block b, k half h) at (2b + h) * 128 bytes. A
// chunk is kSlotCols / cols consecutive channel groups of one step or pass
// (cols: the outputs its k-step feeds), one ring slot.
constexpr int kSlotCols = 64;
constexpr int kSlotElems = 9 * 16 * kSlotCols;  // 18,432 bytes
constexpr int kRingBytes = 2 * kSlotElems * 2;  // two slots
constexpr int kMaxGrowthQ = 3;  // growth convs: 16-output blocks (gc / 16) the engine is built for
// Growth convs: 16-pixel M-tiles per warp the kernel for gc = 16 * NQ holds,
// its sums' registers: the largest tile whose buffer fits beside the ring at
// that gc gives 36 M-tiles of region 0 at gc = 16 (16 x 16), 24 at gc = 32
// (8 x 16), 16 at gc = 48 (8 x 8)
constexpr int kMaxMT[kMaxGrowthQ] = {5, 3, 2};
constexpr int kLastMT = 2;    // last conv: 64-pixel M-blocks per warpgroup (4 at 16 x 16 tiles)
constexpr int kLastN = 64;    // last conv: outputs per pass, wgmma's N at most
constexpr int kMaxNf = 2 * kLastN;  // nf the chain takes: a multiple of 16 up to two passes

// The growth depth each growth width's kernels are built for (the wrapper's
// `growth_depth`): the most convs whose k-step (D * gc outputs) fits a ring
// slot and whose pending sums, D * gc / 2 f32 registers a thread per M-tile
// (kMaxMT of them), take at most 96. 2 at gc = 16 (80 registers; depth 4
// would take 160 and spilled, and ran no faster on an H100), 2 at gc = 32
// (96), 1 (one conv at a time) at gc = 48, where two convs' 96 outputs do
// not fit a slot.
constexpr int kDepth[kMaxGrowthQ] = {2, 2, 1};

// The shapes conv_chain takes: nf a multiple of 16 up to kMaxNf, gc a
// multiple of 16 up to 16 * kMaxGrowthQ, tiles small enough that each
// conv's M-tiles fit the warps' share, and the growth depth its kernel is
// built for.
inline bool chain_fits(int nf, int gc, int th, int tw, int depth) {
  return nf % 16 == 0 && nf >= 16 && nf <= kMaxNf && gc % 16 == 0 && gc >= 16 && gc <= 16 * kMaxGrowthQ &&
         th >= 1 && tw >= 1 &&
         th <= 16 && tw <= 16 && (th + 8) * (tw + 8) <= 16 * kWarps * kMaxMT[gc / 16 - 1] &&
         th * tw <= 16 * kWarps * kLastMT && depth == kDepth[gc / 16 - 1];
}

// Shared memory of a chain kernel: the ring (at the start: wgmma reads it),
// then the feature buffer.
inline size_t chain_smem(int nf, int gc, int th, int tw) {
  return kRingBytes + (size_t)(th + 2 * kHalo) * (tw + 2 * kHalo) * (nf + 4 * gc + kPad) * sizeof(bf16);
}

// Copies the chain's chunks, in order, into ring slots. Every thread holds
// the same state; all of them call `fetch` together. Stream step t is growth
// step t for t < 4, then pass t - 4 of the last conv (outputs kLastN * (t - 4)
// onwards).
struct WeightStream {
  const bf16* w;
  int nf, gc, depth;
  int t = 0, k = 0;  // the next chunk: chunk k of stream step t
  int off = 0;       // its first element in w (under 2^31: 714,240 at nf = 128, gc = 48)
  // step t's 16-channel groups and the outputs its k-step feeds; false past the last step
  __device__ __forceinline__ bool step(int tt, int& groups, int& cols) const {
    if (tt < 4) {
      const int first = tt % depth == 0;  // a group's first step reads every finished slice
      groups = (first ? nf + tt * gc : gc) / 16;
      cols = (depth - tt % depth) * gc;
      return true;
    }
    if ((tt - 4) * kLastN >= nf) return false;
    groups = (nf + 4 * gc) / 16;
    cols = min(kLastN, nf - kLastN * (tt - 4));
    return true;
  }
  __device__ __forceinline__ void fetch(bf16* slot) {
    int groups, cols;
    if (!step(t, groups, cols)) return;  // past the last chunk
    const int per = kSlotCols / cols, ng = min(per, groups - k * per);
    const int vecs = ng * 9 * 2 * cols;  // 16-byte vectors: ng * 9 * 16 * cols / 8
    for (int i = threadIdx.x; i < vecs; i += kThreads) cp_async16(slot + 8 * i, w + off + 8 * i, true);
    off += vecs * 8;
    if (++k * per >= groups) {
      ++t;
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

// One growth step's products for a warp that holds MT M-tiles: channel
// groups ch0 / 16 .. + groups - 1 into the sums of the group's convs P ..
// D - 1, every k-step streamed through the ring (chunks j, j + 1, ..). A
// k-step holds (D - P) * NQ blocks of 16 outputs, each lane's B fragments of
// pending conv p, block q one 16-byte vector at ((k-step * (D - P) + p) * NQ
// + q) * 32 + lane; one A fragment feeds all 2 * NQ * (D - P) n-tiles. Every
// warp of the block holds the same MT: an M-tile past a conv's region
// computes on a pixel of region A (or a clamped one) and is dropped, so the
// loop has no branch and the loads of one tap can run ahead of the products
// of the last.
template <int MT, int NQ, int D, int P>
__device__ __forceinline__ void growth_products(float (&acc)[D][kMaxMT[NQ - 1]][2 * NQ][4],
                                                const unsigned (&base)[kMaxMT[NQ - 1]], WeightStream& ws, bf16* ring,
                                                int& j, int ch0, int groups, int pw, int cp) {
  constexpr int NP = D - P, per = kSlotCols / (16 * NQ * NP);
  for (int k = 0; k * per < groups; ++k, ++j) {
    const uint4* slot = reinterpret_cast<const uint4*>(ring_next(ws, ring, j)) + (threadIdx.x & 31);
    const int ng = min(per, groups - k * per);
#pragma unroll 1
    for (int gl = 0; gl < ng; ++gl) {
      const int ch = ch0 + (k * per + gl) * 16;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint4 b[NP][NQ];
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int q = 0; q < NQ; ++q) b[p][q] = slot[(((gl * 9 + tap) * NP + p) * NQ + q) * 32];
        const int off = ((tap / 3 - 1) * pw + tap % 3 - 1) * cp + ch;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          unsigned a[4];
          ldmatrix_x4_at(a, base[i] + 2 * off);
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              mma_bf16(acc[P + p][i][2 * q], a, b[p][q].x, b[p][q].y);
              mma_bf16(acc[P + p][i][2 * q + 1], a, b[p][q].z, b[p][q].w);
            }
        }
      }
    }
  }
}

// Growth step C of a group (convs A .. A + D - 1, region A: rows and
// columns from r0, rh x rw pixels, M-tiles per warp mt), then the group's
// later steps: the products, then conv C's epilogue, growth(C, buffer y,
// buffer x, channel, v0, v1, ok), ok for the pixels of its own region, C - A
// inside region A's edge (the others compute on a pixel of region A, or any
// valid one, and store nothing).
template <int NQ, int D, int C, class Growth>
__device__ __forceinline__ void growth_step(float (&acc)[D][kMaxMT[NQ - 1]][2 * NQ][4],
                                            const unsigned (&base)[kMaxMT[NQ - 1]], WeightStream& ws, bf16* ring,
                                            int& j, int mt, int r0, int rh, int rw, int pw, int cp,
                                            const Growth& growth) {
  constexpr int A = C / D * D, P = C - A, MT = kMaxMT[NQ - 1];
  const int ch0 = P == 0 ? 0 : ws.nf + (C - 1) * ws.gc;
  const int groups = (P == 0 ? ws.nf + C * ws.gc : ws.gc) / 16;
  switch (mt) {  // M-tiles per warp, the same for the whole block
    case 1: growth_products<1, NQ, D, P>(acc, base, ws, ring, j, ch0, groups, pw, cp); break;
    case 2: growth_products<MT < 2 ? MT : 2, NQ, D, P>(acc, base, ws, ring, j, ch0, groups, pw, cp); break;
    case 3: growth_products<MT < 3 ? MT : 3, NQ, D, P>(acc, base, ws, ring, j, ch0, groups, pw, cp); break;
    case 4: growth_products<MT < 4 ? MT : 4, NQ, D, P>(acc, base, ws, ring, j, ch0, groups, pw, cp); break;
    default: growth_products<MT, NQ, D, P>(acc, base, ws, ring, j, ch0, groups, pw, cp); break;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // accumulator rows g, g + 8; columns 2t, 2t + 1
  // m / rw = (m * inv) >> 16, exact for m < 16 * kWarps * kMaxMT[0] and rw <= 24
  const unsigned inv = (65536u + rw - 1) / rw;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (warp + kWarps * i) * 16 + g + 8 * half;
      const int y = (int)(((unsigned)m * inv) >> 16), x = m - y * rw;
      const bool ok = y >= P && y < rh - P && x >= P && x < rw - P;  // in conv C's region (so in region A)
#pragma unroll
      for (int nt = 0; nt < 2 * NQ; ++nt)
        growth(C, r0 + min(y, rh - 1), r0 + x, nt * 8 + 2 * t, acc[P][i][nt][2 * half],
               acc[P][i][nt][2 * half + 1], ok);
    }
  if constexpr (P + 1 < D) growth_step<NQ, D, C + 1>(acc, base, ws, ring, j, mt, r0, rh, rw, pw, cp, growth);
}

// The four growth convs of conv_chain (below) for gc = 16 * NQ at depth D:
// group A, then the later groups.
template <int NQ, int D, int A, class Growth>
__device__ __forceinline__ void growth_convs(const bf16* feat, WeightStream& ws, bf16* ring, int& j, int pw, int th,
                                             int tw, int cp, const Growth& growth) {
  constexpr int MT = kMaxMT[NQ - 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = 1 + A, rh = th + 2 * kHalo - 2 - 2 * A, rw = tw + 2 * kHalo - 2 - 2 * A;
  const int npix = rh * rw, mtiles = (npix + 15) / 16;
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(feat));
  unsigned base[MT];  // the shared-memory byte address this lane feeds to ldmatrix, for each M-tile
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int m = (warp + kWarps * i) * 16 + (lane & 15);
    if (m >= npix) m = 0;  // rows past the region: any valid pixel, never needed
    base[i] = at + 2 * (((r0 + m / rw) * pw + r0 + m % rw) * cp + (lane >> 4) * 8);
  }
  float acc[D][MT][2 * NQ][4] = {};
  growth_step<NQ, D, A>(acc, base, ws, ring, j, (mtiles + kWarps - 1) / kWarps, r0, rh, rw, pw, cp, growth);
  if constexpr (A + D < 4) growth_convs<NQ, D, A + D>(feat, ws, ring, j, pw, th, tw, cp, growth);
}

// One pass of the last conv: outputs n0 .. n0 + N - 1 over the tile, all
// nf + 4*gc input channels, on wgmma m64nNk16. M-tiles warp, warp + 8 of the
// four warps of a warpgroup are its MB 64-pixel M-blocks (2 at 16 x 16
// tiles, 1 at 8 x 16 and smaller), A comes from registers (ldmatrix, so a tap
// stays an address offset) and B straight from the ring slot, and one A
// fragment feeds all N outputs; the sums go to last(y, x, channel, v0, v1).
// Every warpgroup issues all its M-blocks' products, a block past the tile
// on a clamped pixel, dropped: a wgmma under a branch the compiler cannot
// prove uniform is serialized (ptxas C7520). between() runs before the first
// pass's products.
template <int N, int MB, class Last, class Between>
__device__ __forceinline__ void last_pass(const bf16* feat, WeightStream& ws, bf16* ring, int& j, int n0, int pw,
                                          int th, int tw, int cp, const Last& last, const Between& between) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // accumulator rows g, g + 8; columns 2t, 2t + 1
  const int npix = th * tw;
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(feat));
  unsigned base[MB];  // the shared-memory byte address this lane feeds to ldmatrix, for each M-block
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    int m = (warp + kWarps * i) * 16 + (lane & 15);
    if (m >= npix) m = 0;
    base[i] = at + 2 * (((kHalo + m / tw) * pw + kHalo + m % tw) * cp + (lane >> 4) * 8);
  }
  float acc[MB][N / 2] = {};
  constexpr int per = kSlotCols / N;
  const int groups = (ws.nf + 4 * ws.gc) / 16;
  for (int k = 0; k * per < groups; ++k, ++j) {
    const bf16* slot = ring_next(ws, ring, j);
    if (n0 == 0 && k == 0) between();
    const int ng = min(per, groups - k * per);
#pragma unroll 1
    for (int gl = 0; gl < ng; ++gl) {
      const int ch = (k * per + gl) * 16;
      unsigned a[2][MB][4];  // two sets: the next tap's loads while this tap's products run
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = ((tap / 3 - 1) * pw + tap % 3 - 1) * cp + ch;
#pragma unroll
        for (int i = 0; i < MB; ++i) ldmatrix_x4_at(a[tap & 1][i], base[i] + 2 * off);
        wgmma_fence();
        const unsigned long long b = smem_desc(slot + (gl * 9 + tap) * 16 * N, 128, 256);
#pragma unroll
        for (int i = 0; i < MB; ++i) wgmma_m64k16<N>(acc[i], a[tap & 1][i], b);
        wgmma_commit();
        wgmma_wait<1>();  // the last tap's products are done: its A registers are free
      }
      wgmma_wait<0>();  // before the next ci group (or chunk) starts over with set 0
    }
  }
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = (warp + kWarps * i) * 16 + g + 8 * half;
      if (m >= npix) continue;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        last(kHalo + m / tw, kHalo + m % tw, n0 + nt * 8 + 2 * t, acc[i][4 * nt + 2 * half],
             acc[i][4 * nt + 2 * half + 1]);
    }
}

// The last conv's pass of N outputs at MB M-blocks per warpgroup: MB = 2 where
// the tile has more than 8 M-tiles (16 x 16), else 1.
template <int N, class Last, class Between>
__device__ __forceinline__ void last_pass_mb(const bf16* feat, WeightStream& ws, bf16* ring, int& j, int n0, int pw,
                                             int th, int tw, int cp, const Last& last, const Between& between) {
  if ((th * tw + 15) / 16 > kWarps)
    last_pass<N, 2>(feat, ws, ring, j, n0, pw, th, tw, cp, last, between);
  else
    last_pass<N, 1>(feat, ws, ring, j, n0, pw, th, tw, cp, last, between);
}

// The five 3x3 convs of an RDB chain, bf16 on the tensor cores with f32
// sums, over the pixel-major buffer `feat` (cp = nf + 4*gc + kPad channels
// per pixel, pw pixels per row, the th x tw tile at (kHalo, kHalo)). Growth
// conv c (0..3, gc outputs) reads channels [0, nf + c*gc) over region c, one
// pixel smaller on every side than region c - 1 (region 0: the buffer less
// one pixel), and hands each pair of sums to growth(c, buffer y,
// buffer x, channel, v0, v1), which stores it for the next conv. The last conv
// (nf outputs) reads all nf + 4*gc channels over the tile and hands its
// sums to last(y, x, channel, v0, v1). between() runs once every growth
// output is in the buffer, before the last conv's products. The caller has
// started its buffer loads (plain stores or cp.async, not yet committed); the
// first barrier here covers them. chain_fits() holds.
//
// The weights stream through `ring` (two kSlotElems slots) one chunk ahead
// of the products, so device memory (L2) is read once per block and conv.
// A warp owns M-tiles (16 pixels) warp, warp + 8, ... of each group's
// region; its accumulators stay in registers across the chunks. Growth
// convs run source-major on mma.sync m16n8k16 (growth_step): one A fragment
// (ldmatrix from the buffer) feeds gc / 8 n-tiles of 8 outputs for every
// pending conv of the group (4 n-tiles at gc = 16, 8 at gc = 32, both at
// depth 2). The last conv runs on wgmma (`last_pass`) in passes of at most
// kLastN = 64 outputs: one of nf outputs at nf <= 64 (N = 16, 32, 48 or 64),
// two at 64 < nf <= 128 (64, then nf - 64), each re-reading the buffer's A
// fragments, so the
// accumulators stay at 32 registers per M-block and the ring's slots at
// 64 columns whatever nf is. NQ = gc / 16 is a template parameter, and with
// it the growth depth kDepth[NQ - 1], so each growth width is a kernel of its
// own: gc = 16's code and registers do not depend on the wider ones'. So is
// ANY_NF: the kernels for nf = 64 (false)
// hold only the 64-output pass, those for every other nf (true) the passes of
// 16, 32, 48 and 64 outputs behind a switch, so nf = 64's code is not changed
// by the other widths'.
template <int NQ, bool ANY_NF, class Growth, class Last, class Between>
__device__ __forceinline__ void conv_chain(const bf16* feat, bf16* ring, const bf16* __restrict__ w, int nf,
                                           int gc, int pw, int th, int tw, const Growth& growth, const Last& last,
                                           const Between& between) {
  const int cp = nf + 4 * gc + kPad;
  constexpr int D = kDepth[NQ - 1];
  WeightStream ws{w, nf, gc, D};
  ws.fetch(ring);
  cp_async_commit();
  int j = 0;  // chunks consumed

  growth_convs<NQ, D, 0>(feat, ws, ring, j, pw, th, tw, cp, growth);

  if constexpr (!ANY_NF) {
    last_pass_mb<kLastN>(feat, ws, ring, j, 0, pw, th, tw, cp, last, between);  // nf = 64: one pass
  } else {
    for (int n0 = 0; n0 < nf; n0 += kLastN) {
      switch (min(kLastN, nf - n0)) {
        case 16: last_pass_mb<16>(feat, ws, ring, j, n0, pw, th, tw, cp, last, between); break;
        case 32: last_pass_mb<32>(feat, ws, ring, j, n0, pw, th, tw, cp, last, between); break;
        case 48: last_pass_mb<48>(feat, ws, ring, j, n0, pw, th, tw, cp, last, between); break;
        default: last_pass_mb<64>(feat, ws, ring, j, n0, pw, th, tw, cp, last, between); break;
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
