// Fused residual-dense-block backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rdb_t_bwd_kernel` (climsr_tpu/ops/pallas/rdb.py:432,
// reached through `_rdb_t_bwd_raw` :508). From the forward's saved feature
// buffer feat = [x, h_1 .. h_4] (kernel B1) and the upstream gradient g it
// computes, for out = gx * x + gy * y5 ((gy, gx) = (0.2, 1) or, for the block
// that folds the enclosing residual, (0.04, 0.2)):
//
//   dz_5 = gy * g                                  rounded to g's type
//   dz_k = dfeat(h_k) * (h_k > 0 ? 1 : 0.2)        k = 4..1, rounded to g's type
//   dx   = gx * g + dfeat(x)
//   dW_j = sum over pixels of dz_j (x) feat shifted by each tap    (f32)
//   db_k = sum over pixels of dz_k                                 (f32, growth convs)
//
// where dfeat is the input gradient of the five convs, accumulated in f32.
// Like the TPU kernel, the slopes come from sign(h_k) (LeakyReLU keeps the
// sign), and dz is rounded to g's type exactly where the TPU kernel stores
// its `zbuf`.
//
// The TPU kernel carries dW across its sequential grid in scratch. Blocks on
// Hopper run in no order, so the work is split in three launches, all on the
// caller's stream, with no atomics (the result does not depend on the order
// the blocks run in):
//
// 1. dX (`rdb_bwd_dx_*_kernel`). The input gradient is the forward's chain of
//    five 3x3 convs run backwards: dfeat(h_4) needs dz_5 one pixel around,
//    dfeat(h_3) needs dz_5 and dz_4, ..., dx needs all of them, each one pixel
//    further out. So the kernel is the forward kernel's shape with other
//    weights and epilogues: each block loads gy * g with a 5-pixel halo into
//    a shared-memory buffer B = [dz_5, dz_4, dz_3, dz_2, dz_1] (nf + 4*gc
//    channels) and runs four convs with the transposed, spatially flipped
//    weights (the wrapper packs them once per call), each over a region one
//    pixel smaller, writing dz_k into its slice of B; a fifth conv gives dx.
//    The tile's centre of B goes to device memory as `z`, the input of part 2.
// 2. dW (`rdb_wgrad_*_kernel`): one block per (conv, 16 output channels, tap)
//    and per split of the pixels. Each block walks its share of 8 x 16 pixel
//    tiles, stages dz and feat (with a 1-pixel halo) in shared memory, and sums
//    dz^T . feat_shifted on the tensor cores (bf16: mma.sync with both
//    operands through ldmatrix.trans, f32 sums; f32: CUDA-core FMA). Each split
//    writes its own f32 partial of every dW (and of the growth db).
// 3. A reduction (`rdb_wgrad_reduce_kernel`) sums the partials in a fixed
//    order.
//
// Bound on this card: at the training shape (192 x 64 x 32 x 32, nf=64, gc=16,
// bf16) the backward does twice the forward's products, 97.8 GFLOP (99 us at
// the dense bf16 rate), against 151 MB of feat, g and dx (45 us), so it is
// bound by operations. This first version pays for its simplicity: mma.sync
// from single-stage loops, the halo recompute of part 1 (as the forward), z
// written and read back once (50 MB), and 16 MB of partials.

#include "rdb_common.cuh"

namespace {

using namespace rdb;

// ---------------------------------------------------------------- part 1: dX, bfloat16 on the tensor cores

// dz_k epilogue: dfeat(h_k) times LeakyReLU's slope at h_k (from the saved
// feat), rounded to bf16, into B's channel slice; zero outside the image.
struct SlopeStore {
  bf16* buf;
  const bf16* feat;
  size_t img;
  int cp, pw, ch, hch, total, oy, ox, H, W;
  __device__ __forceinline__ void operator()(int sy, int sx, int c, float v0, float v1) const {
    const int gy = oy + sy, gx = ox + sx;
    __nv_bfloat162 r = __floats2bfloat162_rn(0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const __nv_bfloat162 h =
          *reinterpret_cast<const __nv_bfloat162*>(feat + (img + (size_t)gy * W + gx) * total + hch + c);
      r = __floats2bfloat162_rn(__low2float(h) > 0.f ? v0 : 0.2f * v0, __high2float(h) > 0.f ? v1 : 0.2f * v1);
    }
    *reinterpret_cast<__nv_bfloat162*>(buf + (sy * pw + sx) * cp + ch + c) = r;
  }
};

// dx epilogue: gx * g + dfeat(x), rounded once.
struct DxStore {
  const bf16* g;
  bf16* dx;
  size_t img;
  int oy, ox, H, W, nf;
  float gxs;
  __device__ __forceinline__ void operator()(int sy, int sx, int c, float v0, float v1) const {
    const int gy = oy + sy, gx = ox + sx;
    if (gy >= H || gx >= W) return;
    const size_t o = (img + (size_t)gy * W + gx) * nf + c;
    const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(g + o);
    *reinterpret_cast<__nv_bfloat162*>(dx + o) =
        __floats2bfloat162_rn(gxs * __low2float(gv) + v0, gxs * __high2float(gv) + v1);
  }
};

__global__ void __launch_bounds__(kThreads)
    rdb_bwd_dx_bf16_kernel(const bf16* __restrict__ g, const bf16* __restrict__ feat, bf16* __restrict__ dx,
                           bf16* __restrict__ z, const uint4* __restrict__ w, int H, int W, int nf, int gc, int th,
                           int tw, float gys, float gxs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);
  const int total = nf + 4 * gc;
  const int ph = th + 2 * kHalo, pw = tw + 2 * kHalo, cp = total + kPad;
  const int oy = blockIdx.y * th - kHalo;  // image coordinates of buffer pixel (0, 0)
  const int ox = blockIdx.x * tw - kHalo;
  const size_t img = (size_t)blockIdx.z * H * W;

  // dz_5 = gy * g with its halo, rounded to bf16; zero outside the image
  const int vecs = nf / 8;
  for (int i = threadIdx.x; i < ph * pw * vecs; i += kThreads) {
    const int v = i % vecs, pix = i / vecs;
    const int gy = oy + pix / pw, gx = ox + pix % pw;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      val = *reinterpret_cast<const uint4*>(g + (img + (size_t)gy * W + gx) * nf + v * 8);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(gys * __low2float(h[j]), gys * __high2float(h[j]));
    }
    *reinterpret_cast<uint4*>(buf + pix * cp + v * 8) = val;
  }
  __syncthreads();

  const uint4* wk = w;
  for (int s = 0; s < 4; ++s) {  // dz_4, dz_3, dz_2, dz_1
    const int cin = nf + s * gc;
    const SlopeStore epi{buf, feat, img, cp, pw, cin, nf + (3 - s) * gc, total, oy, ox, H, W};
    conv3x3_mma(buf, cp, pw, 1 + s, ph - 2 - 2 * s, pw - 2 - 2 * s, cin, gc, wk, epi);
    wk += (size_t)(gc / 16) * (9 * cin / 16) * 32;
    __syncthreads();
  }
  const int tv = total / 8;  // the tile's B to device memory, for part 2
  for (int i = threadIdx.x; i < th * tw * tv; i += kThreads) {
    const int v = i % tv, pix = i / tv, sy = pix / tw, sx = pix % tw;
    const int gy = oy + kHalo + sy, gx = ox + kHalo + sx;
    if (gy < H && gx < W)
      *reinterpret_cast<uint4*>(z + (img + (size_t)gy * W + gx) * total + v * 8) =
          *reinterpret_cast<const uint4*>(buf + ((kHalo + sy) * pw + kHalo + sx) * cp + v * 8);
  }
  const DxStore epi{g, dx, img, oy, ox, H, W, nf, gxs};
  conv3x3_mma(buf, cp, pw, kHalo, th, tw, total, nf, wk, epi);
}

// ---------------------------------------------------------------- part 1: dX, float32 on the CUDA cores

__global__ void __launch_bounds__(kThreads)
    rdb_bwd_dx_f32_kernel(const float* __restrict__ g, const float* __restrict__ feat, float* __restrict__ dx,
                          float* __restrict__ z, const float* __restrict__ w, int H, int W, int nf, int gc, int th,
                          int tw, float gys, float gxs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* buf = reinterpret_cast<float*>(smem_raw);  // channel-major planes
  const int total = nf + 4 * gc;
  const int ph = th + 2 * kHalo, pw = tw + 2 * kHalo, plane = ph * pw;
  const int oy = blockIdx.y * th - kHalo;
  const int ox = blockIdx.x * tw - kHalo;
  const size_t img = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.x;

  for (int i = tid; i < plane * nf; i += kThreads) {
    const int c = i % nf, pix = i / nf;
    const int gy = oy + pix / pw, gx = ox + pix % pw;
    buf[c * plane + pix] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W) ? gys * g[(img + (size_t)gy * W + gx) * nf + c] : 0.f;
  }
  __syncthreads();

  const float* wk = w;
  for (int s = 0; s < 4; ++s) {
    const int cin = nf + s * gc, hch = nf + (3 - s) * gc;
    const int r0 = 1 + s;
    const int rh = ph - 2 - 2 * s, rw = pw - 2 - 2 * s;
    const int pairs_x = rw / kP, npairs = rh * pairs_x;
    for (int it = tid; it < npairs * (gc / kQ); it += kThreads) {
      const int q0 = (it / npairs) * kQ, pr = it % npairs;
      const int sy = r0 + pr / pairs_x, sx = r0 + (pr % pairs_x) * kP;
      float acc[kP][kQ] = {};
      conv3x3_fma(acc, buf, cin, plane, pw, wk + q0, gc, sy, sx);
      const int gy = oy + sy;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int gx = ox + sx + p;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float* h = feat + (img + (size_t)(inside ? gy : 0) * W + (inside ? gx : 0)) * total + hch + q0;
        float* dst = buf + (size_t)(cin + q0) * plane + sy * pw + sx + p;
#pragma unroll
        for (int q = 0; q < kQ; ++q) dst[q * plane] = inside ? (h[q] > 0.f ? acc[p][q] : 0.2f * acc[p][q]) : 0.f;
      }
    }
    wk += (size_t)9 * cin * gc;
    __syncthreads();
  }
  for (int i = tid; i < th * tw * total; i += kThreads) {
    const int c = i % total, pix = i / total, sy = pix / tw, sx = pix % tw;
    const int gy = oy + kHalo + sy, gx = ox + kHalo + sx;
    if (gy < H && gx < W)
      z[(img + (size_t)gy * W + gx) * total + c] = buf[(size_t)c * plane + (kHalo + sy) * pw + kHalo + sx];
  }

  const int pairs_x = tw / kP, npairs = th * pairs_x;
  for (int it = tid; it < npairs * (nf / kQ); it += kThreads) {
    const int q0 = (it / npairs) * kQ, pr = it % npairs;
    const int sy = kHalo + pr / pairs_x, sx = kHalo + (pr % pairs_x) * kP;
    float acc[kP][kQ] = {};
    conv3x3_fma(acc, buf, total, plane, pw, wk + q0, nf, sy, sx);
    const int gy = oy + sy;
    if (gy >= H) continue;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int gx = ox + sx + p;
      if (gx >= W) continue;
      const size_t o = (img + (size_t)gy * W + gx) * nf + q0;
#pragma unroll
      for (int q = 0; q < kQ; ++q) dx[o + q] = gxs * g[o + q] + acc[p][q];
    }
  }
}

// ---------------------------------------------------------------- part 2: dW, split over pixels

constexpr int kWThreads = 128;
constexpr int kTH = 8, kTW = 16;  // pixel tile: 8 rows of 16 = 128 pixels = 8 k-steps of 16
constexpr int kFH = kTH + 2, kFW = kTW + 2;  // feat tile with a 1-pixel halo

// Which dW a block computes: conv j (0..4), 16 output channels from co0, one tap.
struct Job {
  int j, co0, tap, cin, cout, zc;  // zc: the first of the 16 dz channels in z
  size_t woff;                     // the conv's first weight in the flat [dW_1 .. dW_5] (OIHW each)
};

__device__ __forceinline__ Job job_of(int b, int nf, int gc) {
  Job o;
  const int growth = 4 * (gc / 16) * 9;
  int q;
  if (b < growth) {
    o.j = b / ((gc / 16) * 9);
    q = (b / 9) % (gc / 16);
  } else {
    o.j = 4;
    q = (b - growth) / 9;
  }
  o.tap = b % 9;
  o.cin = nf + o.j * gc;
  o.cout = o.j < 4 ? gc : nf;
  o.co0 = 16 * q;
  o.zc = (o.j < 4 ? nf + (3 - o.j) * gc : 0) + o.co0;  // z = [dz_5, dz_4, dz_3, dz_2, dz_1]
  o.woff = 0;
  for (int i = 0; i < o.j; ++i) o.woff += (size_t)9 * gc * (nf + i * gc);
  return o;
}

// Stage one pixel tile: 16 dz channels of 128 pixels, and feat's first cin
// channels with a 1-pixel halo; zero outside the image. Rows are zs_stride /
// fs_stride elements apart (16-byte multiples).
template <class T>
__device__ __forceinline__ void stage_tile(T* zs, int zs_stride, T* fs, int fs_stride, const T* __restrict__ z,
                                           const T* __restrict__ feat, const Job& jb, size_t img, int ty0, int tx0,
                                           int H, int W, int total) {
  constexpr int E = 16 / sizeof(T);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < kTH * kTW * (16 / E); i += kWThreads) {
    const int v = i % (16 / E), pix = i / (16 / E);
    const int gy = ty0 + pix / kTW, gx = tx0 + pix % kTW;
    uint4 val = zero;
    if (gy < H && gx < W)
      val = *reinterpret_cast<const uint4*>(z + (img + (size_t)gy * W + gx) * total + jb.zc + v * E);
    *reinterpret_cast<uint4*>(zs + pix * zs_stride + v * E) = val;
  }
  const int cv = jb.cin / E;
  for (int i = threadIdx.x; i < kFH * kFW * cv; i += kWThreads) {
    const int v = i % cv, pix = i / cv;
    const int gy = ty0 - 1 + pix / kFW, gx = tx0 - 1 + pix % kFW;
    uint4 val = zero;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = *reinterpret_cast<const uint4*>(feat + (img + (size_t)gy * W + gx) * total + v * E);
    *reinterpret_cast<uint4*>(fs + pix * fs_stride + v * E) = val;
  }
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// The growth convs' db: the block of the centre tap sums its 16 dz channels.
template <class T>
__device__ __forceinline__ void sum_db(float& acc, const T* zs, int zs_stride) {
  for (int p = 0; p < kTH * kTW; ++p) acc += to_f32(zs[p * zs_stride + threadIdx.x]);
}

__global__ void __launch_bounds__(kWThreads)
    rdb_wgrad_bf16_kernel(const bf16* __restrict__ z, const bf16* __restrict__ feat, float* __restrict__ partial,
                          float* __restrict__ db_partial, int n, int H, int W, int nf, int gc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int zstride = 16 + kPad;  // 48-byte rows: ldmatrix rows on distinct banks
  const Job jb = job_of(blockIdx.x, nf, gc);
  const int fstride = jb.cin + kPad;
  const int total = nf + 4 * gc;
  bf16* zs = reinterpret_cast<bf16*>(smem_raw);
  bf16* fs = zs + kTH * kTW * zstride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mi = lane >> 3, r = lane & 7;
  const int ty = jb.tap / 3, tx = jb.tap % 3;
  const int ctiles = jb.cin / 16;
  const bool with_db = jb.tap == 4 && jb.j < 4 && threadIdx.x < 16;

  float acc[2][2][4] = {};
  float db = 0.f;
  const int tiles_y = (H + kTH - 1) / kTH, tiles_x = (W + kTW - 1) / kTW;
  const int tiles = n * tiles_y * tiles_x;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const size_t img = (size_t)(t / (tiles_y * tiles_x)) * H * W;
    const int ty0 = ((t / tiles_x) % tiles_y) * kTH, tx0 = (t % tiles_x) * kTW;
    __syncthreads();  // the last tile's reads are done
    stage_tile(zs, zstride, fs, fstride, z, feat, jb, img, ty0, tx0, H, W, total);
    __syncthreads();
    if (with_db) sum_db(db, zs, zstride);
#pragma unroll 1
    for (int kk = 0; kk < kTH; ++kk) {  // k-step kk: the 16 pixels of tile row kk
      // A = dz^T (16 channels x 16 pixels): matrices (pixels 0-7 | 8-15) x (channels 0-7 | 8-15)
      unsigned a[4];
      ldmatrix_x4_trans(a, zs + (kk * kTW + (mi >> 1) * 8 + r) * zstride + (mi & 1) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ct = warp + 4 * i;
        if (ct >= ctiles) break;
        // B = feat shifted by the tap (16 pixels x 16 channels): b0, b1 of two n-tiles of 8
        unsigned b[4];
        ldmatrix_x4_trans(b, fs + ((kk + ty) * kFW + (mi & 1) * 8 + r + tx) * fstride + ct * 16 + (mi >> 1) * 8);
        mma_bf16(acc[i][0], a, b[0], b[1]);
        mma_bf16(acc[i][1], a, b[2], b[3]);
      }
    }
  }

  // C rows g, g + 8 are output channels, columns 2t, 2t + 1 input channels
  float* out = partial + (size_t)blockIdx.y * (9 * (size_t)(4 * gc * nf + 6 * gc * gc + nf * total)) + jb.woff;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ct = warp + 4 * i;
    if (ct >= ctiles) break;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = jb.co0 + g + 8 * (e >> 1), ci = ct * 16 + nt * 8 + 2 * tq + (e & 1);
        out[((size_t)co * jb.cin + ci) * 9 + jb.tap] = acc[i][nt][e];
      }
  }
  if (with_db) db_partial[(size_t)blockIdx.y * 4 * gc + jb.j * gc + jb.co0 + threadIdx.x] = db;
}

__global__ void __launch_bounds__(kWThreads)
    rdb_wgrad_f32_kernel(const float* __restrict__ z, const float* __restrict__ feat, float* __restrict__ partial,
                         float* __restrict__ db_partial, int n, int H, int W, int nf, int gc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kOut = 16;  // outputs per thread: 16 channels x cin <= 2048 = 16 x 128 threads
  const Job jb = job_of(blockIdx.x, nf, gc);
  const int total = nf + 4 * gc;
  float* zs = reinterpret_cast<float*>(smem_raw);
  float* fs = zs + kTH * kTW * 16;
  const int ty = jb.tap / 3, tx = jb.tap % 3;
  const bool with_db = jb.tap == 4 && jb.j < 4 && threadIdx.x < 16;
  const int outs = 16 * jb.cin;

  float acc[kOut] = {};
  float db = 0.f;
  const int tiles_y = (H + kTH - 1) / kTH, tiles_x = (W + kTW - 1) / kTW;
  const int tiles = n * tiles_y * tiles_x;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const size_t img = (size_t)(t / (tiles_y * tiles_x)) * H * W;
    const int ty0 = ((t / tiles_x) % tiles_y) * kTH, tx0 = (t % tiles_x) * kTW;
    __syncthreads();
    stage_tile(zs, 16, fs, jb.cin, z, feat, jb, img, ty0, tx0, H, W, total);
    __syncthreads();
    if (with_db) sum_db(db, zs, 16);
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int e = threadIdx.x + i * kWThreads;
      if (e >= outs) break;
      const int co = e / jb.cin, ci = e % jb.cin;
      float s = 0.f;
#pragma unroll 4
      for (int p = 0; p < kTH * kTW; ++p)
        s = fmaf(zs[p * 16 + co], fs[((p / kTW + ty) * kFW + p % kTW + tx) * jb.cin + ci], s);
      acc[i] += s;
    }
  }
  float* out = partial + (size_t)blockIdx.y * (9 * (size_t)(4 * gc * nf + 6 * gc * gc + nf * total)) + jb.woff;
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int e = threadIdx.x + i * kWThreads;
    if (e >= outs) break;
    const int co = e / jb.cin, ci = e % jb.cin;
    out[((size_t)(jb.co0 + co) * jb.cin + ci) * 9 + jb.tap] = acc[i];
  }
  if (with_db) db_partial[(size_t)blockIdx.y * 4 * gc + jb.j * gc + jb.co0 + threadIdx.x] = db;
}

// ---------------------------------------------------------------- part 3: sum the splits in a fixed order

__global__ void rdb_wgrad_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ db_partial,
                                        float* __restrict__ dw, float* __restrict__ db, int wtotal, int btotal,
                                        int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < wtotal) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * wtotal + e];
    dw[e] = s;
  } else if (e < wtotal + btotal) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += db_partial[(size_t)k * btotal + e - wtotal];
    db[e - wtotal] = s;
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Plain C entry point (bound with ctypes). `w` is the transposed, flipped
// weight chain packed for the dtype (bf16 fragment order or f32 tap-major);
// `z` (N x H x W x (nf + 4*gc)), `partial` (splits x the weight count) and
// `db_partial` (splits x 4*gc) are scratch; dw is [dW_1 .. dW_5], each OIHW,
// and db the growth convs' [db_1 .. db_4], both f32. Returns a cudaError_t
// value; 0 is success.
extern "C" int climsr_rdb_bwd(const void* feat, const void* g, const void* w, void* dx, void* z, float* partial,
                              float* db_partial, float* dw, float* db, int n, int h, int w_, int nf, int gc, int th,
                              int tw, int splits, float gy_scale, float gx_scale, int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w_ < 1 || th < 1 || tw < 1 || n > 65535 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (nf % 16 || gc % 16 || nf + 4 * gc > 128) return (int)cudaErrorInvalidValue;  // wgrad: <= 2 tiles of 16 per warp
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = nf + 4 * gc;
  const dim3 grid((w_ + tw - 1) / tw, (h + th - 1) / th, n);
  const dim3 wgrid(9 * (4 * (gc / 16) + nf / 16), splits);
  cudaError_t err;
  if (is_bf16) {
    const size_t smem = (size_t)(th + 2 * kHalo) * (tw + 2 * kHalo) * (total + kPad) * sizeof(bf16);
    if ((err = allow_smem(rdb_bwd_dx_bf16_kernel, smem)) != cudaSuccess) return (int)err;
    rdb_bwd_dx_bf16_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(g), static_cast<const bf16*>(feat), static_cast<bf16*>(dx), static_cast<bf16*>(z),
        static_cast<const uint4*>(w), h, w_, nf, gc, th, tw, gy_scale, gx_scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t wsmem = (size_t)(kTH * kTW * (16 + kPad) + kFH * kFW * (total + kPad)) * sizeof(bf16);
    if ((err = allow_smem(rdb_wgrad_bf16_kernel, wsmem)) != cudaSuccess) return (int)err;
    rdb_wgrad_bf16_kernel<<<wgrid, kWThreads, wsmem, s>>>(static_cast<const bf16*>(z), static_cast<const bf16*>(feat),
                                                          partial, db_partial, n, h, w_, nf, gc);
  } else {
    if (tw % kP) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)total * (th + 2 * kHalo) * (tw + 2 * kHalo) * sizeof(float);
    if ((err = allow_smem(rdb_bwd_dx_f32_kernel, smem)) != cudaSuccess) return (int)err;
    rdb_bwd_dx_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(feat), static_cast<float*>(dx),
        static_cast<float*>(z), static_cast<const float*>(w), h, w_, nf, gc, th, tw, gy_scale, gx_scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t wsmem = (size_t)(kTH * kTW * 16 + kFH * kFW * total) * sizeof(float);
    if ((err = allow_smem(rdb_wgrad_f32_kernel, wsmem)) != cudaSuccess) return (int)err;
    rdb_wgrad_f32_kernel<<<wgrid, kWThreads, wsmem, s>>>(static_cast<const float*>(z),
                                                         static_cast<const float*>(feat), partial, db_partial, n, h,
                                                         w_, nf, gc);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int wtotal = 9 * (4 * gc * nf + 6 * gc * gc + nf * total), btotal = 4 * gc;
  rdb_wgrad_reduce_kernel<<<(wtotal + btotal + 255) / 256, 256, 0, s>>>(partial, db_partial, dw, db, wtotal, btotal,
                                                                         splits);
  return (int)cudaGetLastError();
}
