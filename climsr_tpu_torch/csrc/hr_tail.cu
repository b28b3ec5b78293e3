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
// Bound on this card: at the training head's shape (192 x 64 x 128 x 128,
// bf16) the tail does 2.36e11 operations (74,880 per pixel: 0.238 ms at the
// dense bf16 rate) and must move 409 MB (0.122 ms at 3.35 TB/s), so it is
// bound by operations: by HRconv's products on the tensor cores. What holds
// this design back (phase clocks): the products at about half the tensor
// cores' rate, each m64n64k16 re-reading its 2 KB B tile from shared memory
// beside A's ldmatrix, and the 1.375x halo recompute.
//
// bfloat16 (`hr_tail_bf16_kernel`): HRconv runs the way `conv_chain` runs an
// RDB's last conv (rdb_common.cuh), on wgmma m64n64k16 with all of its
// weights in shared memory, and conv_last on the tensor cores too:
//
// - Persistent blocks, one per SM, whose two warpgroups are independent
//   workers: each walks its own share of 12 x 16 output tiles with its own
//   named barrier, so one's CUDA-core phases (lrelu, epilogue, shift-adds)
//   run while the other's products hold the tensor cores. A tile's HRconv
//   region (the tile plus a 1-pixel ring) is 14 x 18 = 252 pixels, four
//   64-row M-blocks (4 rows spare), all in the one warpgroup. 12 x 16 is
//   chosen over 14 x 14 (a 16 x 16 region, also four M-blocks) because it
//   wastes less at the images this runs on: HRconv computes 1.375x the
//   outputs' pixels at 128 x 128 (14 x 14 tiles: 1.56x, as 140 of 128
//   columns) and 1.34x at 512 x 512 (14 x 14: 1.34x); 16 x 16 tiles with six
//   M-blocks compute 1.5x at both.
// - The weights: HRconv's 73,728 bytes are copied into shared memory once per
//   block, in wgmma's K-major B layout without swizzle (ops/rdb.py
//   `chain_index`, the last conv's order: k-step (16 input channels, tap),
//   core matrices of 8 outputs x 8 k), so device memory serves them once per
//   SM and not once per warp item.
// - x: the tile with a 2-pixel halo (16 x 20 pixels), pixel-major with 72
//   channels per pixel (the eight rows of an ldmatrix on distinct banks, a
//   tap an address offset), fetched with cp.async as soon as the last tile's
//   products are done, so it lands under that tile's epilogue and conv_last
//   (zero-filled outside the image: SAME padding), then lrelu'd in place.
// - Products: A from registers by ldmatrix (three register sets: two k-steps'
//   products in flight while the next loads), B by descriptor from the
//   resident weights; one A fragment feeds all 64 outputs. f32 sums.
// - The epilogue adds the bias, takes lrelu and rounds into a bf16
//   intermediate of 14 x 18 pixels x 64 channels (16-byte chunks XOR-swizzled
//   by the pixel, zero outside the image: conv_last's SAME padding), which
//   never leaves the SM.
// - conv_last (64 -> 1): a projection of the intermediate onto its 9 taps on
//   the tensor cores (mma.sync, M = the region's pixels, N = 9 taps padded to
//   16, K = 64), then each output adds its 9 shifted projections in f32, in
//   order. The dy shifts cross warps, so the projection goes through shared
//   memory (9 floats a pixel, over the intermediate once it has been read).
//   On the CUDA cores conv_last took 39% of a block's SM clocks.
// - Shared memory: weights 73,728 + per warpgroup an x stage 46,080 and the
//   intermediate 32,256 = 230,400 of the 232,448 bytes a block may use.
//
// float32 (`hr_tail_f32_kernel`, the f32 checks' path): one block per 16 x 16
// output tile, HRconv on the CUDA cores (`conv3x3_fma`) over channel-major
// planes, weights tap-major [tap][cin][cout].
//
// With -DCLIMSR_PHASE_CLOCKS (climsr_tpu_torch/scripts/rdb_phase_clocks.py)
// thread 0 of each bf16 block sums the SM clocks its warpgroup spends in each
// phase of its tiles and writes the sums to g_phase_clocks[block][phase].

#include "rdb_common.cuh"

namespace {

using namespace rdb;

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.2f * v; }

constexpr int kC = 64;  // channels of x and of HRconv

// ---------------------------------------------------------------- bfloat16, tensor cores

constexpr int kTH = 12, kTW = 16;            // output tile
constexpr int kRH = kTH + 2, kRW = kTW + 2;  // HRconv region: 14 x 18
constexpr int kRegion = kRH * kRW;           // 252 pixels: four 64-row M-blocks
constexpr int kMB = 4;                       // M-blocks of a tile, all in one warpgroup
constexpr int kSH = kTH + 4, kSW = kTW + 4;  // staged x: 16 x 20
constexpr int kXP = kC + kPad;               // staged x and the intermediate: channels per pixel (72)
constexpr int kStageElems = kSH * kSW * kXP;
constexpr int kWElems = 9 * kC * kC;         // HRconv's weights: 36 k-steps of 16 x 64
constexpr int kHidElems = kRegion * kC;      // the intermediate: 64 channels per pixel, chunks swizzled
constexpr int kGroups = kThreads / 128;      // warpgroups: independent workers, 2
static_assert(kRegion <= kMB * 64 && kRegion * 9 * 4 <= kHidElems * 2, "four M-blocks; the projection fits hid");
constexpr size_t kSmemBf16 = (size_t)(kWElems + kGroups * (kStageElems + kHidElems)) * sizeof(bf16);  // 230,400

// The intermediate's element (pixel m, channel c): 16-byte chunk c / 8 of
// the pixel's 128 bytes stored at chunk (c / 8) ^ (m & 7), so the eight rows
// of an ldmatrix, and the epilogue's stores, fall on distinct banks.
__device__ __forceinline__ int hid_at(int m, int c) { return m * kC + ((((c >> 3) ^ m) & 7) << 3) + (c & 7); }

// Phase sums for -DCLIMSR_PHASE_CLOCKS (warpgroup 0's): its tile's x landed
// and lrelu'd in place, HRconv's products (and the next tile's copies
// issued), their epilogue, conv_last's projection, its shift-adds.
struct PhaseSums {
#ifdef CLIMSR_PHASE_CLOCKS
  long long last, sum[kPhases];
  __device__ __forceinline__ void start() {
    last = clock64();
    for (int i = 0; i < kPhases; ++i) sum[i] = 0;
  }
  __device__ __forceinline__ void mark(int i) {
    const long long now = clock64();
    sum[i] += now - last;
    last = now;
  }
  __device__ __forceinline__ void write() const {
    if (g_phase_clocks != nullptr && threadIdx.x == 0)
      for (int i = 0; i < kPhases; ++i) g_phase_clocks[(size_t)blockIdx.x * kPhases + i] = sum[i];
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void write() const {}
#endif
};

// the 128 threads of warpgroup `wg` wait for each other (named barrier 1 + wg)
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// one block per SM: 230,400 bytes of shared memory, two independent warpgroups
__global__ void __launch_bounds__(kThreads, 1)
    hr_tail_bf16_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, const bf16* __restrict__ whr,
                        const float* __restrict__ bhr, const uint4* __restrict__ wcl, const float* __restrict__ bcl,
                        int H, int W, int tiles_y, int tiles_x, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wt = tid & 127, ww = warp & 3;  // warpgroup, its thread, its warp
  const int g = lane >> 2, t4 = lane & 3;  // accumulator rows g, g + 8; columns 2 t4, 2 t4 + 1
  bf16* wsm = reinterpret_cast<bf16*>(smem_raw);           // HRconv's weights (at the start: wgmma reads them)
  bf16* xs = wsm + kWElems + wg * (kStageElems + kHidElems);  // this warpgroup's x: [kSH * kSW][kXP]
  bf16* hid = xs + kStageElems;                               // its intermediate: [kRegion][kC], hid_at
  float* proj = reinterpret_cast<float*>(hid);  // conv_last's projection [kRegion][9], over hid once it is read
  PhaseSums clocks;
  clocks.start();

  for (int i = tid; i < kWElems / 8; i += kThreads) cp_async16(wsm + 8 * i, whr + 8 * i, true);
  cp_async_commit();
  cp_async_wait_all();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the weights' copies, to wgmma
  __syncthreads();
  const float bl = *bcl;

  // the staged element each lane feeds to ldmatrix for M-block i (region
  // pixels 64 i + 16 ww + (lane & 15)): region pixel m at stage (m / kRW + 1, m % kRW + 1)
  int base[kMB];
#pragma unroll
  for (int i = 0; i < kMB; ++i) {
    int m = 64 * i + 16 * ww + (lane & 15);
    if (m >= kRegion) m = 0;  // rows past the region: any staged pixel, result dropped
    base[i] = ((m / kRW + 1) * kSW + m % kRW + 1) * kXP + (lane >> 4) * 8;
  }

  // tile t's x with its 2-pixel halo into the stage, 16 bytes at a time; zero outside the image
  auto fetch = [&](int t) {
    if (t >= tiles) return;
    const int n = t / (tiles_y * tiles_x), r = t % (tiles_y * tiles_x);
    const int oy = (r / tiles_x) * kTH - 2, ox = (r % tiles_x) * kTW - 2;
    const bf16* xn = x + (size_t)n * H * W * kC;
    for (int i = wt; i < kSH * kSW * (kC / 8); i += 128) {
      const int v = i % (kC / 8), pix = i / (kC / 8);
      const int gy = oy + pix / kSW, gx = ox + pix % kSW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(xs + pix * kXP + v * 8, inside ? xn + ((size_t)gy * W + gx) * kC + v * 8 : x, inside);
    }
  };
  fetch(kGroups * blockIdx.x + wg);
  cp_async_commit();

  for (int t = kGroups * blockIdx.x + wg; t < tiles; t += kGroups * gridDim.x) {
    const int n = t / (tiles_y * tiles_x), r = t % (tiles_y * tiles_x);
    const int ty0 = (r / tiles_x) * kTH, tx0 = (r % tiles_x) * kTW;
    cp_async_wait_all();
    group_sync(wg);  // x has landed; the last tile's shift-adds are done with proj (hid)
    for (int i = wt; i < kSH * kSW * (kC / 8); i += 128) {  // lrelu in place, rounded to bf16
      uint4* p = reinterpret_cast<uint4*>(xs + (i / (kC / 8)) * kXP + (i % (kC / 8)) * 8);
      uint4 v = *p;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(lrelu(__low2float(h[j])), lrelu(__high2float(h[j])));
      *p = v;
    }
    group_sync(wg);
    clocks.mark(0);

    float acc[kMB][kLastN / 2] = {};
    unsigned a[3][kMB][4];  // three sets: two k-steps' products in flight while the next one loads
#pragma unroll
    for (int ks = 0; ks < 9 * kC / 16; ++ks) {  // k-step (16 input channels gl, tap), gl outermost
      const int gl = ks / 9, tap = ks % 9;
      const int off = ((tap / 3 - 1) * kSW + tap % 3 - 1) * kXP + gl * 16;
      wgmma_wait<2>();  // k-step ks - 3's products are done: its A registers are free
#pragma unroll
      for (int i = 0; i < kMB; ++i) ldmatrix_x4(a[ks % 3][i], xs + base[i] + off);
      wgmma_fence();
      const unsigned long long b = smem_desc(wsm + ks * 16 * kLastN, 128, 256);
#pragma unroll
      for (int i = 0; i < kMB; ++i) wgmma_m64k16<64>(acc[i], a[ks % 3][i], b);
      wgmma_commit();
    }
    wgmma_wait<0>();
    group_sync(wg);  // every warp is done reading x: the next tile's copies land under the rest
    fetch(t + kGroups * gridDim.x);
    cp_async_commit();
    clocks.mark(1);

    // bias, lrelu, round; zero outside the image (conv_last's SAME padding)
#pragma unroll
    for (int i = 0; i < kMB; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 64 * i + 16 * ww + g + 8 * half;
        if (m >= kRegion) continue;
        const int gy = ty0 - 1 + m / kRW, gx = tx0 - 1 + m % kRW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int nt = 0; nt < kLastN / 8; ++nt) {
          const int c = nt * 8 + 2 * t4;
          __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
          if (inside)
            v = __floats2bfloat162_rn(lrelu(acc[i][4 * nt + 2 * half] + __ldg(bhr + c)),
                                      lrelu(acc[i][4 * nt + 2 * half + 1] + __ldg(bhr + c + 1)));
          *reinterpret_cast<__nv_bfloat162*>(hid + hid_at(m, c)) = v;
        }
      }
    group_sync(wg);
    clocks.mark(2);

    // conv_last's projection on the tensor cores: proj[m][tap] = sum_c hid[m][c] * Wcl[tap][c]
    // (mma.sync, M = the 16 M-tiles of region pixels, 4 per warp, N = 9 taps padded to 16, K = 64), f32
    uint4 wb[kC / 16];  // its B fragments (2 KB, from L1: not held across the products)
#pragma unroll
    for (int cs = 0; cs < kC / 16; ++cs) wb[cs] = __ldg(wcl + cs * 32 + lane);
    float q[kMB][2][4] = {};
#pragma unroll
    for (int i = 0; i < kMB; ++i) {
      int m = (ww + 4 * i) * 16 + (lane & 15);
      if (m >= kRegion) m = 0;
#pragma unroll
      for (int cs = 0; cs < kC / 16; ++cs) {
        unsigned av[4];
        ldmatrix_x4(av, hid + hid_at(m, cs * 16 + (lane >> 4) * 8));
        mma_bf16(q[i][0], av, wb[cs].x, wb[cs].y);
        mma_bf16(q[i][1], av, wb[cs].z, wb[cs].w);
      }
    }
    group_sync(wg);  // every warp is done reading hid: proj goes over it
    // n-tile 0 holds taps 2 t4, 2 t4 + 1; n-tile 1 taps 8 + 2 t4, 9 + 2 t4 (only 8 is used)
#pragma unroll
    for (int i = 0; i < kMB; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int mm = (ww + 4 * i) * 16 + g + 8 * half;
        if (mm >= kRegion) continue;
        float* pr = proj + mm * 9;
        pr[2 * t4] = q[i][0][2 * half];
        pr[2 * t4 + 1] = q[i][0][2 * half + 1];
        if (t4 == 0) pr[8] = q[i][1][2 * half];
      }
    group_sync(wg);
    clocks.mark(3);

    // the shift-adds: out = sum over the taps of proj[output pixel + tap's offset][tap], in order, + bias
    for (int j = wt; j < kTH * kTW; j += 128) {
      const int oy = j / kTW, ox = j % kTW;  // region pixel (oy + 1, ox + 1)
      float v = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) v += proj[((oy + tap / 3) * kRW + ox + tap % 3) * 9 + tap];
      const int gy = ty0 + oy, gx = tx0 + ox;
      if (gy < H && gx < W) out[((size_t)n * H + gy) * W + gx] = __float2bfloat16_rn(v + bl);
    }
    clocks.mark(4);
  }
  clocks.write();
}

// ---------------------------------------------------------------- float32, CUDA cores

constexpr int kT = 16;      // output tile: kT x kT pixels, one per thread
constexpr int kX = kT + 4;  // staged lrelu(x): 2-pixel halo
constexpr int kR = kT + 2;  // HRconv region: 1-pixel ring
static_assert(kT * kT == kThreads, "one output pixel per thread");
constexpr size_t kSmemF32 = (size_t)kC * kX * kX * 4 + (size_t)kC * kR * kR * 4 + 9 * kC * 4;

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
// whr packed for the type (bf16: wgmma's K-major B tiles in `chain_index`'s
// last-conv order; f32: tap-major [tap][cin][cout]), bhr (64 f32), wcl (9 x 64
// f32, [tap][cin]), bcl (1 f32). Returns a cudaError_t value; 0 is success.
extern "C" int climsr_hr_tail(const void* x, void* out, const void* whr, const float* bhr, const void* wcl,
                              const float* bcl, int n, int h, int w, int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    const int tiles_y = (h + kTH - 1) / kTH, tiles_x = (w + kTW - 1) / kTW;
    const long long tiles = (long long)n * tiles_y * tiles_x;
    int dev, sms;
    if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaFuncSetAttribute(hr_tail_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kSmemBf16)) != cudaSuccess)
      return (int)err;
    const long long pairs = (tiles + kGroups - 1) / kGroups;  // a block's two warpgroups take a tile each
    hr_tail_bf16_kernel<<<(int)(pairs < sms ? pairs : sms), kThreads, kSmemBf16, s>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const bf16*>(whr), bhr,
        static_cast<const uint4*>(wcl), bcl, h, w, tiles_y, tiles_x, (int)tiles);
  } else {
    const dim3 grid((w + kT - 1) / kT, (h + kT - 1) / kT, n);
    if ((err = cudaFuncSetAttribute(hr_tail_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kSmemF32)) != cudaSuccess)
      return (int)err;
    hr_tail_f32_kernel<<<grid, kThreads, kSmemF32, s>>>(static_cast<const float*>(x), static_cast<float*>(out),
                                                         static_cast<const float*>(whr), bhr,
                                                         static_cast<const float*>(wcl), bcl, h, w);
  }
  return (int)cudaGetLastError();
}

#ifdef CLIMSR_PHASE_CLOCKS
// The phase-clock build only: where the bf16 kernel writes its sums (blocks x
// kPhases int64 on the device, or null for none).
extern "C" int climsr_hr_tail_phase_clocks(void* clocks) {
  return (int)cudaMemcpyToSymbol(rdb::g_phase_clocks, &clocks, sizeof(clocks));
}
#endif
