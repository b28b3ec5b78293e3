// Input gradient of a SAME 9x9 conv, for input channel 0 only, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_dx_c0_kernel` (climsr_tpu/ops/pallas/head_bwd.py:53,
// reached through `conv9_dx_c0` :82): the backward of the ESRGAN fusion head's
// conv1 (9x9, cin -> cout = 64) to the one input channel that carries a
// gradient (the generator's output; the others are elevation and mask):
//
//   out[n, y, x] = sum over u, v in 0..8 and c < cout of
//                  W[c, 0, u, v] * g[n, y + 4 - u, x + 4 - v, c]       (g zero outside)
//
// g is N x H x W x cout (channels_last), in bf16 or f32; the sums are f32 and
// the output is rounded once to g's type.
//
// Bound on this card: at the training shape (192 x 64 x 128 x 128, bf16) the
// kernel must read 403 MB of g (120 us at 3.35 TB/s) and do 16.3 G multiply-
// adds (33 us on the tensor cores, 490 us on the f32 CUDA cores). It is bound
// by memory only if the products run on the tensor cores.
//
// bfloat16 (`conv9_dx_c0_bf16_kernel`, cout = 64): the products on the tensor
// cores, g read from device memory once. With Wrev[dy, dx, c] = W[c, 0, 8 - dy,
// 8 - dx] (dy, dx in 0..8),
//
//   out[y, x] = sum_dx P_y[x + dx - 4, dx],
//   P_y[s, dx] = sum over dy, c of g[y + dy - 4, s, c] * Wrev[dy, dx, c]
//
// so for one output row y, P_y is a plain GEMM: M = the row's source columns
// (the strip's width plus 8), N = dx (9 used, padded to 16), K = (dy, c) =
// 576. A is g's staged pixels, and a change of dy is a change of staged row.
// Only the 9-term anti-diagonal sum over dx leaves the accumulators: each warp
// writes its P values (f32) to a strip of 9 floats per source column in
// shared memory, and after the next barrier one thread per output column adds
// its 9 in a fixed order and rounds once. The 81-tap projection V of kernel F
// never exists.
//
// - Staging: a block walks DOWN a strip of columns (the whole width up to 128
//   output columns, so no column is read twice) two output rows per step, and
//   keeps g's rows in a ring of 12 row slots: the 10 source rows a step reads
//   and the 2 the next step needs, loaded with cp.async at the start of the
//   step before, under its products. One pixel = 64 channels = 128 bytes,
//   the 16-byte chunks XOR-swizzled by the pixel's column (chunk c at
//   c ^ (p & 7)), so the eight rows of an ldmatrix fall on distinct banks
//   without padding. The blocks are persistent, one per SM: block b takes
//   its share of the (image, strip, output row) sequence in order, so g is
//   read once but for 8 rows of halo where a block's share starts inside an
//   image (about 2 per block).
// - Products: mma.sync m16n8k16 with A by ldmatrix from the ring, one
//   16-column M-tile per warp (9 warps cover the 136 source columns of a
//   128-wide strip). Each staged row's A fragment feeds both output rows of
//   the step (at dy and dy - 1), and each k-step of B (Wrev, 18,432 bytes,
//   packed by the wrapper in B-fragment order) is fetched once per step
//   through L1 (18 KB beside 228 KB of shared memory) and serves both rows.
//   B does not stay in registers: 9 warps put 3 on one SM sub-partition,
//   whose 16K registers cap a thread at 168, and B alone is 144. wgmma is
//   not used: its 64-row M-block would cover the 136 columns in 192 rows
//   (1.41x) against mma.sync's 144 (1.06x), and with N = 16 its A operand,
//   read from shared memory either way, is the cost.
// - Shared memory: the ring 12 x 136 x 128 = 208,896 bytes and the P strips
//   of two steps (one being summed while the next is written), 2 x 2 rows x
//   136 x 9 floats = 19,584 bytes: 228,480 of the 232,448 a block may use.
// - What still holds it back (3x its bound on an H100): mma.sync issues at
//   about half of wgmma's rate, N = 16 computes 16 columns for 9, and the 9
//   warps sit 3 to one sub-partition; the products, not device memory, set
//   the pace.
//
// float32 (`conv9_dx_c0_f32_kernel`, the f32 checks' path, any cout divisible
// by 16): each block owns a 32 x 32 output tile and walks the channels in
// chunks of 16, staged with a 4-pixel halo as channel-major f32 planes beside
// the chunk's flipped weights; each thread sums 4 adjacent outputs on the
// CUDA cores.

#include "rdb_common.cuh"

namespace {

using rdb::bf16;

// ---------------------------------------------------------------- bfloat16, tensor cores

constexpr int kCout = 64;                         // g's channels: the fusion head's conv1 outputs
constexpr int kMaxT = 128;                        // widest strip of output columns
constexpr int kRowPix = kMaxT + 8;                // a ring row: the widest strip's source columns
constexpr int kPixBytes = kCout * 2;              // 128
constexpr int kRowBytes = kRowPix * kPixBytes;    // 17,408
constexpr int kRows = 2;                          // output rows per step: each staged row feeds both
constexpr int kSpan = 8 + kRows;                  // source rows one step reads: 10
constexpr int kRing = kSpan + kRows;              // row slots: 10 read + 2 landing for the next step
constexpr int kWarpsB = (kRowPix + 15) / 16;      // one 16-column M-tile per warp: 9
constexpr int kThreadsB = 32 * kWarpsB;
constexpr int kStrip = kRowPix * 9;               // floats: P[source column][dx < 9] of one row
constexpr size_t kSmemB = (size_t)kRing * kRowBytes + 2 * kRows * kStrip * sizeof(float);  // 228,480

// One (image, strip) run of output rows y0 .. y0 + len - 1 of a block.
struct Segment {
  const bf16* g;  // the image's g
  bf16* out;      // the image's output at row y0, column x0
  int H, W, y0, len, x0, tw, npix;  // strip: tw output columns from x0, npix = tw + 8 source columns
};

// Source rows q0 .. q1 - 1 of a segment (image row y0 - 4 + q) into ring
// slots q % kRing, 16 bytes at a time, the chunk c of pixel p at c ^ (p & 7);
// zero outside the image. One cp.async commit group (empty when q1 <= q0).
__device__ __forceinline__ void load_rows(unsigned char* ring, const Segment& s, const bf16* any, int q0, int q1) {
  for (int q = q0; q < q1; ++q) {
    const int r = s.y0 - 4 + q;
    const bool row_in = r >= 0 && r < s.H;
    unsigned char* slot = ring + (q % kRing) * kRowBytes;
    for (int i = threadIdx.x; i < s.npix * 8; i += kThreadsB) {
      const int p = i >> 3, c = i & 7, col = s.x0 - 4 + p;
      const bool ok = row_in && col >= 0 && col < s.W;
      rdb::cp_async16(slot + p * kPixBytes + ((c ^ (p & 7)) << 4),
                      ok ? s.g + ((size_t)r * s.W + col) * kCout + c * 8 : any, ok);
    }
  }
  rdb::cp_async_commit();
}

// Output rows i .. i + kRows - 1 (those < len) from a strip buffer: out[j] =
// sum_dx P[j + dx][dx], added in order and rounded once.
__device__ __forceinline__ void emit_rows(const float* strips, const Segment& s, int i) {
  for (int j = threadIdx.x; j < kRows * s.tw; j += kThreadsB) {
    const int r = j / s.tw, col = j % s.tw;
    if (i + r >= s.len) continue;
    const float* p = strips + r * kStrip + col * 9;
    float v = 0.f;
#pragma unroll
    for (int dx = 0; dx < 9; ++dx) v += p[dx * 10];
    s.out[(size_t)(i + r) * s.W + col] = __float2bfloat16_rn(v);
  }
}

// `wp`: Wrev as a (16 x 576) matrix [dx][dy * 64 + c] (rows 9..15 zero) in
// mma.m16n8k16 B-fragment order: k-step 4 dy + c / 16, lane l's 16 bytes at
// (4 dy + c / 16) * 32 + l. The block takes rows [total * b / G, total * (b +
// 1) / G) of the sequence (image, strip, output row), strips of T columns.
__global__ void __launch_bounds__(kThreadsB, 1)
    conv9_dx_c0_bf16_kernel(const bf16* __restrict__ g, const uint4* __restrict__ wp, bf16* __restrict__ out, int H,
                            int W, int strips, int T, long long total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  float* strip = reinterpret_cast<float*>(smem_raw + (size_t)kRing * kRowBytes);  // [2 steps][kRows][kStrip]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // accumulator rows gq, gq + 8; columns 2tq, 2tq + 1
  const uint4* wl = wp + lane;

  const long long r_end = total * (blockIdx.x + 1) / gridDim.x;
  for (long long f = total * blockIdx.x / gridDim.x; f < r_end;) {
    const long long seg = f / H;
    Segment s;
    s.H = H, s.W = W, s.y0 = (int)(f % H), s.len = (int)min((long long)(H - s.y0), r_end - f);
    f += s.len;
    const int n = (int)(seg / strips);
    s.x0 = (int)(seg % strips) * T, s.tw = min(T, W - s.x0), s.npix = s.tw + 8;
    s.g = g + (size_t)n * H * W * kCout;
    s.out = out + ((size_t)n * H + s.y0) * W + s.x0;
    const int last = (s.len - 1) / kRows * kRows;  // the segment's last step
    const int q_end = last + kSpan;                // source rows it reads: q < q_end

    // the byte of a ring row this lane feeds to ldmatrix, for each 16-channel step
    int m = warp * 16 + (lane & 15);
    if (m >= s.npix) m = 0;  // columns past the strip: any staged pixel, result dropped
    int coff[4];
#pragma unroll
    for (int cs = 0; cs < 4; ++cs) coff[cs] = m * kPixBytes + (((2 * cs + (lane >> 4)) ^ (m & 7)) << 4);
    const bool active = warp * 16 < s.npix;

    load_rows(ring, s, g, 0, kSpan);
    for (int i = 0; i < s.len; i += kRows) {
      rdb::cp_async_wait_all();  // this step's rows have landed (this thread's copies)
      __syncthreads();           // everyone's; the last step's products and strips are done
      load_rows(ring, s, g, i + kSpan, min(i + kSpan + kRows, q_end));  // into the slots the last step read first
      if (i > 0) emit_rows(strip + ((i / kRows - 1) & 1) * kRows * kStrip, s, i - kRows);
      if (!active) continue;
      // P of rows i + r (r < kRows): staged row i + j feeds row i + r at dy = j - r
      float acc[kRows][2][4] = {};
      uint4 bl[kRows][4];  // B of dy = j - r, for r = 0 .. kRows - 1: each k-step fetched once per step
      int slot = i % kRing;
#pragma unroll
      for (int j = 0; j < kSpan; ++j) {
#pragma unroll
        for (int r = kRows - 1; r > 0; --r)
#pragma unroll
          for (int cs = 0; cs < 4; ++cs) bl[r][cs] = bl[r - 1][cs];
        if (j < 9) {
#pragma unroll
          for (int cs = 0; cs < 4; ++cs) bl[0][cs] = __ldg(wl + (4 * j + cs) * 32);
        }
        const unsigned char* row = ring + slot * kRowBytes;
#pragma unroll
        for (int cs = 0; cs < 4; ++cs) {
          unsigned a[4];
          rdb::ldmatrix_x4(a, reinterpret_cast<const bf16*>(row + coff[cs]));
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (j - r < 0 || j - r > 8) continue;
            rdb::mma_bf16(acc[r][0], a, bl[r][cs].x, bl[r][cs].y);
            rdb::mma_bf16(acc[r][1], a, bl[r][cs].z, bl[r][cs].w);
          }
        }
        slot = slot + 1 == kRing ? 0 : slot + 1;
      }
      // P[col][dx]: n-tile 0 holds dx = 2tq, 2tq + 1; n-tile 1 dx = 8 + 2tq, 9 + 2tq (only 8 is used)
      float* sb = strip + ((i / kRows) & 1) * kRows * kStrip;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = warp * 16 + gq + 8 * half;
          if (col >= s.npix) continue;
          float* p = sb + r * kStrip + col * 9;
          p[2 * tq] = acc[r][0][2 * half];
          p[2 * tq + 1] = acc[r][0][2 * half + 1];
          if (tq == 0) p[8] = acc[r][1][2 * half];
        }
    }
    rdb::cp_async_wait_all();
    __syncthreads();  // the last step's strips are complete; the ring is free for the next segment
    emit_rows(strip + ((last / kRows) & 1) * kRows * kStrip, s, last);
  }
}

// ---------------------------------------------------------------- float32, CUDA cores

constexpr int kT = 32;            // output tile: 32 x 32 pixels
constexpr int kS = kT + 8;        // staged input tile with a 4-pixel halo
constexpr int kC = 16;            // channels per chunk
constexpr int kPx = 4;            // outputs per thread, along x
constexpr int kThreads = kT * kT / kPx;
constexpr size_t kSmem = (kC * kS * (kS + 1) + kC * 81) * sizeof(float);  // 110 KB: two blocks per SM

// wf[c][u'][v'] = W[c, 0, 8 - u', 8 - v'] (f32, packed by the wrapper)
__global__ void __launch_bounds__(kThreads)
    conv9_dx_c0_f32_kernel(const float* __restrict__ g, const float* __restrict__ wf, float* __restrict__ out, int H,
                           int W, int cout) {
  extern __shared__ float smem[];
  float(*gs)[kS][kS + 1] = reinterpret_cast<float(*)[kS][kS + 1]>(smem);  // [kC][kS][kS + 1]
  float* ws = smem + kC * kS * (kS + 1);                                  // [kC * 81]
  const int tid = threadIdx.x;
  const int oy = blockIdx.y * kT, ox = blockIdx.x * kT;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int ty = tid / (kT / kPx), tx = (tid % (kT / kPx)) * kPx;

  float acc[kPx] = {};
  for (int c0 = 0; c0 < cout; c0 += kC) {
    __syncthreads();  // the last chunk's reads are done
    for (int i = tid; i < kS * kS * kC; i += kThreads) {
      const int c = i % kC, pix = i / kC;
      const int gy = oy - 4 + pix / kS, gx = ox - 4 + pix % kS;
      gs[c][pix / kS][pix % kS] =
          (gy >= 0 && gy < H && gx >= 0 && gx < W) ? g[(img + (size_t)gy * W + gx) * cout + c0 + c] : 0.f;
    }
    for (int i = tid; i < kC * 81; i += kThreads) ws[i] = wf[(size_t)c0 * 81 + i];
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kC; ++c) {
#pragma unroll 1
      for (int u = 0; u < 9; ++u) {
        float r[kPx + 8];
#pragma unroll
        for (int j = 0; j < kPx + 8; ++j) r[j] = gs[c][ty + u][tx + j];
        const float* wr = ws + c * 81 + u * 9;
#pragma unroll
        for (int v = 0; v < 9; ++v) {
          const float wv = wr[v];
#pragma unroll
          for (int p = 0; p < kPx; ++p) acc[p] = fmaf(wv, r[p + v], acc[p]);
        }
      }
    }
  }
  const int gy = oy + ty;
  if (gy >= H) return;
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const int gx = ox + tx + p;
    if (gx < W) out[img + (size_t)gy * W + gx] = acc[p];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): g (N x H x W x cout), out (N x H
// x W), `w` the wrapper's packing for the type: bf16 (cout = 64) Wrev in
// B-fragment order, or f32 (cout divisible by 16) wf = W[:, 0] flipped, cout
// x 81. Returns a cudaError_t value; 0 is success.
extern "C" int climsr_conv9_dx_c0(const void* g, const void* w, void* out, int n, int h, int w_, int cout,
                                  int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w_ < 1 || n > 65535 || cout < 1 || cout % kC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    if (cout != kCout) return (int)cudaErrorInvalidValue;
    const int strips = (w_ + kMaxT - 1) / kMaxT, T = (w_ + strips - 1) / strips;
    if ((strips - 1) * T >= w_) return (int)cudaErrorInvalidValue;
    int dev, sms;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    const long long total = (long long)n * strips * h;
    const int grid = (int)(total < sms ? total : sms);
    if ((err = cudaFuncSetAttribute(conv9_dx_c0_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kSmemB)) != cudaSuccess)
      return (int)err;
    conv9_dx_c0_bf16_kernel<<<grid, kThreadsB, kSmemB, s>>>(static_cast<const bf16*>(g),
                                                             static_cast<const uint4*>(w), static_cast<bf16*>(out),
                                                             h, w_, strips, T, total);
  } else {
    const dim3 grid((w_ + kT - 1) / kT, (h + kT - 1) / kT, n);
    if ((err = cudaFuncSetAttribute(conv9_dx_c0_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kSmem)) != cudaSuccess)
      return (int)err;
    conv9_dx_c0_f32_kernel<<<grid, kThreads, kSmem, s>>>(static_cast<const float*>(g),
                                                          static_cast<const float*>(w), static_cast<float*>(out), h,
                                                          w_, cout);
  }
  return (int)cudaGetLastError();
}
