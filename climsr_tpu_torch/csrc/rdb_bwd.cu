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
//    weights (the wrapper packs them with one gather per call), each over a
//    region one pixel smaller, writing dz_k into its slice of B; a fifth conv
//    gives dx. The tile's centre of B goes to device memory as `z`, the input
//    of part 2. In bf16 this is the forward's `conv_chain` (rdb_common.cuh):
//    weights through a two-slot shared-memory ring, the growth steps
//    source-major on mma.sync (step s's sum splits by B's slices like the
//    forward's, so dz_5's slice feeds steps 0 and 1 from one read at gc = 16
//    and 32, and the transposed weights pack in the same step order) and
//    wgmma for the nf-channel last conv (passes of at most 64 outputs), the
//    tile, shared memory and growth depth of kernel A at the same widths, one
//    block per SM. The slope's h is read at a pixel clamped into the image
//    whether or not the output is stored, so an epilogue's loads go out
//    together.
// 2. dW (`rdb_wgrad_*_kernel`). bf16: one block per job and split of the
//    pixel tiles. A job is a 16-channel group of z (dz_5 in nf / 16 groups,
//    then dz_4 .. dz_1, each the output gradient of one conv) and at most 128
//    of that conv's input channels, a conv's inputs cut in near-equal parts
//    of whole 16-channel groups: at nf = 64, 8 jobs at gc = 16; 18 at
//    gc = 32, where conv5's 192 inputs and conv4's 160 are cut in two halves
//    each. The job and split tables come from the wrapper (`wgrad_plan`):
//    33 splits at the training shape and gc = 16, so 264 blocks fill the 132
//    SMs twice. For each 8 x 16 pixel tile the block stages its 16 dz
//    channels and its job's feat channels with a 1-pixel halo once
//    (cp.async, zero-filled outside the
//    image, double-buffered: the next tile's copies run under this tile's
//    products, 2 x 55,104 bytes, two blocks per SM), and all nine taps are
//    address offsets into that stage: a warp owns (16 input channels, tap)
//    pairs, and one ldmatrix.trans A fragment of dz^T feeds up to 9 of them,
//    mma.sync m16n8k16 with f32 sums. So feat is staged 8 times per call,
//    not once per (conv, 16 outputs, tap) as in the first version (~61
//    times). Each block writes its slice of dW (16 runs of 9 x its input
//    channels in OIHW) through shared memory 16 bytes at a time, and the
//    job that starts at input channel 0 the growth db from a fixed-order
//    sum, as its split's f32 partial. f32: one block per (conv, 16 outputs,
//    tap) and split, CUDA-core FMA, in passes of 2,048 outputs.
// 3. A reduction (`rdb_wgrad_reduce_kernel`) sums the partials in a fixed
//    order. No atomics anywhere: two calls on the same inputs give the same
//    bits.
//
// Bound on this card: at the training shape (192 x 64 x 32 x 32, nf=64, gc=16,
// bf16) the backward does twice the forward's products, 97.8 GFLOP (99 us at
// the dense bf16 rate), against 151 MB of feat, g and dx (45 us), so it is
// bound by operations. What still holds it back: part 1 is kernel A's chain
// with the same limits (its growth products at mma.sync's rate, conv5's
// wgmma one tap deep, one block per SM, the halo recompute) plus a global
// read of h per growth output for the slope; part 2 reads feat's
// shifted rows from shared memory once per 16 outputs (16 operations per
// byte, the same bound as the growth convs), and z is written and read back
// once (50 MB) with 16 MB of partials.

#include "rdb_common.cuh"

namespace {

using namespace rdb;

// ---------------------------------------------------------------- part 1: dX, bfloat16 on the tensor cores

// Step s's epilogue (dz_{4-s}): dfeat(h_{4-s}) times LeakyReLU's slope at
// h_{4-s} (from the saved feat), rounded to bf16, into B's channel slice
// nf + s*gc; zero outside the image. Stores only where ok; h is read at the
// pixel clamped into the image whatever ok is, so the unrolled epilogue
// issues its loads together.
struct SlopeStore {
  bf16* buf;
  const bf16* feat;
  size_t img;
  int cp, pw, nf, gc, total, oy, ox, H, W;
  __device__ __forceinline__ void operator()(int s, int sy, int sx, int c, float v0, float v1, bool ok) const {
    const int gy = oy + sy, gx = ox + sx;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int cy = min(max(gy, 0), H - 1), cx = min(max(gx, 0), W - 1);
    const unsigned hv = __ldg(reinterpret_cast<const unsigned*>(
        feat + (img + (size_t)cy * W + cx) * total + nf + (3 - s) * gc + c));
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hv);
    const __nv_bfloat162 r = __floats2bfloat162_rn(inside ? (__low2float(h) > 0.f ? v0 : 0.2f * v0) : 0.f,
                                                   inside ? (__high2float(h) > 0.f ? v1 : 0.2f * v1) : 0.f);
    if (ok) *reinterpret_cast<__nv_bfloat162*>(buf + (sy * pw + sx) * cp + nf + s * gc + c) = r;
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

template <int NQ, bool ANY_NF>  // gc = 16 * NQ: one kernel per growth width and nf = 64 or not, as kernel A
__global__ void __launch_bounds__(kThreads, 1)
    rdb_bwd_dx_bf16_kernel(const bf16* __restrict__ g, const bf16* __restrict__ feat, bf16* __restrict__ dx,
                           bf16* __restrict__ z, const bf16* __restrict__ w, int H, int W, int nf, int gc, int th,
                           int tw, float gys, float gxs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // chain_smem: the ring, then the buffer
  const int total = nf + 4 * gc;
  const int ph = th + 2 * kHalo, pw = tw + 2 * kHalo, cp = total + kPad;
  bf16* buf = ring + 2 * kSlotElems;
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

  // steps 0..3 give dz_4, dz_3, dz_2, dz_1; the last conv gives dx
  const SlopeStore growth{buf, feat, img, cp, pw, nf, gc, total, oy, ox, H, W};
  const DxStore last{g, dx, img, oy, ox, H, W, nf, gxs};
  conv_chain<NQ, ANY_NF>(buf, ring, w, nf, gc, pw, th, tw, growth, last, [&] {
    const int tv = total / 8;  // the tile's B to device memory, for part 2
    for (int i = threadIdx.x; i < th * tw * tv; i += kThreads) {
      const int v = i % tv, pix = i / tv, sy = pix / tw, sx = pix % tw;
      const int gy = oy + kHalo + sy, gx = ox + kHalo + sx;
      if (gy < H && gx < W)
        *reinterpret_cast<uint4*>(z + (img + (size_t)gy * W + gx) * total + v * 8) =
            *reinterpret_cast<const uint4*>(buf + ((kHalo + sy) * pw + kHalo + sx) * cp + v * 8);
    }
  });
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

// f32: which dW a block computes: conv j (0..4), 16 output channels from co0, one tap.
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

// f32: stage one pixel tile: 16 dz channels of 128 pixels, and feat's first
// cin channels with a 1-pixel halo; zero outside the image. Rows are
// zs_stride / fs_stride elements apart (16-byte multiples).
__device__ __forceinline__ void stage_tile(float* zs, int zs_stride, float* fs, int fs_stride,
                                           const float* __restrict__ z, const float* __restrict__ feat, const Job& jb,
                                           size_t img, int ty0, int tx0, int H, int W, int total) {
  constexpr int E = 4;  // floats per 16 bytes
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

// f32: the growth convs' db: the block of the centre tap sums its 16 dz channels.
__device__ __forceinline__ void sum_db(float& acc, const float* zs, int zs_stride) {
  for (int p = 0; p < kTH * kTW; ++p) acc += zs[p * zs_stride + threadIdx.x];
}

// bf16: one block per (16-channel group of z, split of the pixel tiles). The
// job table (the wrapper's `wgrad_plan`) gives each group's conv and dW
// slice, the split table each split's tiles. For each tile the block stages
// the group's 16 dz channels and feat's first cin channels with a 1-pixel
// halo once, and runs all nine taps on them as address offsets: a warp owns
// (16 input channels, tap) pairs warp, warp + 8, ... (at most 9: 8 input
// tiles x 9 taps over 8 warps), so one A fragment of dz^T feeds up to 18
// products per k-step. Tiles stream
// through two stages with cp.async, the next tile's copies in flight while
// the current tile's products run. 2 blocks per SM.
constexpr int kWPairs = 9;            // (input tile, tap) pairs per warp: cic <= 128
constexpr int kMaxCic = 16 * kWPairs * kWarps / 9;  // 128 input channels per job
constexpr int kJobInts = 7;           // ints per row of the job table
constexpr int kZStride = 16 + kPad;   // staged dz: 48-byte rows, ldmatrix rows on distinct banks

// one stage: 128 pixels x 16 dz channels, 10 x 18 pixels x cic feat channels
__host__ __device__ constexpr int wgrad_stage_elems(int cic) {
  return kTH * kTW * kZStride + kFH * kFW * (cic + kPad);
}

// One staged tile's products for a warp that holds NP (input tile, tap)
// pairs: for each tile row (k-step of 16 pixels) one A fragment of dz^T and
// NP B fragments of feat shifted by the pair's tap. Every warp of the block
// holds the same NP (a pair past the conv's last repeats it and is dropped),
// so the loop has no branch.
template <int NP>
__device__ __forceinline__ void wgrad_products(float (&acc)[kWPairs][2][4], const bf16* zs, const bf16* fs,
                                               const int (&poff)[kWPairs], int fstride) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll 2
  for (int kk = 0; kk < kTH; ++kk) {  // k-step kk: the 16 pixels of tile row kk
    // A = dz^T (16 channels x 16 pixels): matrices (pixels 0-7 | 8-15) x (channels 0-7 | 8-15)
    unsigned a[4];
    ldmatrix_x4_trans(a, zs + (kk * kTW + (mi >> 1) * 8 + r) * kZStride + (mi & 1) * 8);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      // B = feat shifted by the tap (16 pixels x 16 channels): b0, b1 of two n-tiles of 8
      unsigned b[4];
      ldmatrix_x4_trans(b, fs + poff[i] + kk * kFW * fstride);
      mma_bf16(acc[i][0], a, b[0], b[1]);
      mma_bf16(acc[i][1], a, b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    rdb_wgrad_bf16_kernel(const bf16* __restrict__ z, const bf16* __restrict__ feat, const int* __restrict__ jobs,
                          const int* __restrict__ bounds, float* __restrict__ partial, float* __restrict__ db_partial,
                          int njobs, int H, int W, int nf, int gc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int job = blockIdx.x % njobs, split = blockIdx.x / njobs;
  // job row: z channel, conv (0..4), first output channel, cin, the conv's first weight in
  // [dW_1 .. dW_5], and the block's input channels ci0 .. ci0 + cic - 1 (cic <= 128)
  const int* row = jobs + kJobInts * job;
  const int zc = row[0], j = row[1], co0 = row[2], cin = row[3], woff = row[4], ci0 = row[5], cic = row[6];
  const int total = nf + 4 * gc, fstride = cic + kPad, npairs = 9 * (cic / 16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = lane >> 3, r = lane & 7;
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
  const int stage_elems = wgrad_stage_elems(cic);

  // this lane's ldmatrix row in the staged feat for each of its pairs (tap ty, tx; input tile ct)
  int poff[kWPairs];
#pragma unroll
  for (int i = 0; i < kWPairs; ++i) {
    const int p = min(warp + kWarps * i, npairs - 1), ct = p / 9, tap = p % 9;
    poff[i] = ((tap / 3) * kFW + (mi & 1) * 8 + r + tap % 3) * fstride + ct * 16 + (mi >> 1) * 8;
  }

  const int tiles_y = (H + kTH - 1) / kTH, tiles_x = (W + kTW - 1) / kTW;
  // tile t's dz (16 channels of 128 pixels) and feat (cic channels of 10 x 18 pixels), zero outside the image
  auto stage = [&](int t, bf16* zs) {
    const size_t img = (size_t)(t / (tiles_y * tiles_x)) * H * W;
    const int ty0 = ((t / tiles_x) % tiles_y) * kTH, tx0 = (t % tiles_x) * kTW;
    for (int i = tid; i < kTH * kTW * 2; i += kThreads) {
      const int v = i & 1, pix = i >> 1, gy = ty0 + pix / kTW, gx = tx0 + pix % kTW;
      const bool inside = gy < H && gx < W;
      cp_async16(zs + pix * kZStride + v * 8, inside ? z + (img + (size_t)gy * W + gx) * total + zc + v * 8 : z,
                 inside);
    }
    bf16* fs = zs + kTH * kTW * kZStride;
    const int cv = cic / 8;
    for (int i = tid; i < kFH * kFW * cv; i += kThreads) {
      const int v = i % cv, pix = i / cv, gy = ty0 - 1 + pix / kFW, gx = tx0 - 1 + pix % kFW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(fs + pix * fstride + v * 8,
                 inside ? feat + (img + (size_t)gy * W + gx) * total + ci0 + v * 8 : feat, inside);
    }
  };

  float acc[kWPairs][2][4] = {};
  float db = 0.f;  // growth convs: dz channel tid % 16 over pixels tid / 16 + 16 i
  const bool growth = j < 4 && ci0 == 0;  // one job of each 16 growth outputs sums their db
  const int t0 = bounds[split], t1 = bounds[split + 1];
  if (t0 < t1) stage(t0, stages);
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    bf16* zs = stages + ((t - t0) & 1) * stage_elems;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1's stage
    if (t + 1 < t1) stage(t + 1, stages + ((t + 1 - t0) & 1) * stage_elems);
    cp_async_commit();
    const bf16* fs = zs + kTH * kTW * kZStride;
    if (growth)
#pragma unroll
      for (int p = tid >> 4; p < kTH * kTW; p += kThreads / 16) db += __bfloat162float(zs[p * kZStride + (tid & 15)]);
    switch ((npairs + kWarps - 1) / kWarps) {  // pairs per warp: 5 .. 9 for cic = 64 .. 128
      case 1: wgrad_products<1>(acc, zs, fs, poff, fstride); break;
      case 2: wgrad_products<2>(acc, zs, fs, poff, fstride); break;
      case 3: wgrad_products<3>(acc, zs, fs, poff, fstride); break;
      case 4: wgrad_products<4>(acc, zs, fs, poff, fstride); break;
      case 5: wgrad_products<5>(acc, zs, fs, poff, fstride); break;
      case 6: wgrad_products<6>(acc, zs, fs, poff, fstride); break;
      case 7: wgrad_products<7>(acc, zs, fs, poff, fstride); break;
      case 8: wgrad_products<8>(acc, zs, fs, poff, fstride); break;
      default: wgrad_products<9>(acc, zs, fs, poff, fstride); break;
    }
  }

  // The block's slice of dW_j, rows co0 .. co0 + 15 and input channels ci0 ..
  // ci0 + cic - 1 of its OIHW weight, is 16 contiguous runs of 9 * cic: lay it
  // out in shared memory, then write it 16 bytes at a time.
  cp_async_wait_all();
  __syncthreads();  // the stages are free
  float* slice = reinterpret_cast<float*>(smem_raw);  // [16][cic][9]
  float* dbs = slice + 16 * 9 * cic;                  // [16 pixel groups][16 channels]
  const int g = lane >> 2, tq = lane & 3;  // C rows g, g + 8 are output channels, columns 2tq, 2tq + 1 input channels
#pragma unroll
  for (int i = 0; i < kWPairs; ++i) {
    const int p = warp + kWarps * i, ct = p / 9, tap = p % 9;
    if (p >= npairs) break;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = g + 8 * (e >> 1), ci = ct * 16 + nt * 8 + 2 * tq + (e & 1);
        slice[(co * cic + ci) * 9 + tap] = acc[i][nt][e];
      }
  }
  if (growth) dbs[tid] = db;
  __syncthreads();
  const size_t wtotal = 9 * (size_t)(4 * gc * nf + 6 * gc * gc + nf * total);
  const int run = 9 * cic / 4;  // float4s of one output channel's run
  const float4* src = reinterpret_cast<const float4*>(slice);
  float4* out = reinterpret_cast<float4*>(partial + split * wtotal + woff + ((size_t)co0 * cin + ci0) * 9);
  for (int i = tid; i < 16 * run; i += kThreads) out[(i / run) * (9 * cin / 4) + i % run] = src[i];
  if (growth && tid < 16) {  // the 16 pixel groups in a fixed order
    float s = 0.f;
    for (int q = 0; q < kThreads / 16; ++q) s += dbs[q * 16 + tid];
    db_partial[(size_t)split * 4 * gc + j * gc + co0 + tid] = s;
  }
}

__global__ void __launch_bounds__(kWThreads)
    rdb_wgrad_f32_kernel(const float* __restrict__ z, const float* __restrict__ feat, float* __restrict__ partial,
                         float* __restrict__ db_partial, int n, int H, int W, int nf, int gc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kOut = 16;  // outputs per thread and pass: 16 channels x 128 inputs = 16 x 128 threads
  const Job jb = job_of(blockIdx.x, nf, gc);
  const int total = nf + 4 * gc;
  float* zs = reinterpret_cast<float*>(smem_raw);
  float* fs = zs + kTH * kTW * 16;
  const int ty = jb.tap / 3, tx = jb.tap % 3;
  const int outs = 16 * jb.cin;
  const int tiles_y = (H + kTH - 1) / kTH, tiles_x = (W + kTW - 1) / kTW;
  const int tiles = n * tiles_y * tiles_x;
  float* out = partial + (size_t)blockIdx.y * (9 * (size_t)(4 * gc * nf + 6 * gc * gc + nf * total)) + jb.woff;

  // outputs e0 .. e0 + kOut * kWThreads - 1 per pass (one pass for cin <= 128), every tile staged in each
  for (int e0 = 0; e0 < outs; e0 += kOut * kWThreads) {
    const bool with_db = e0 == 0 && jb.tap == 4 && jb.j < 4 && threadIdx.x < 16;
    float acc[kOut] = {};
    float db = 0.f;
    for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
      const size_t img = (size_t)(t / (tiles_y * tiles_x)) * H * W;
      const int ty0 = ((t / tiles_x) % tiles_y) * kTH, tx0 = (t % tiles_x) * kTW;
      __syncthreads();
      stage_tile(zs, 16, fs, jb.cin, z, feat, jb, img, ty0, tx0, H, W, total);
      __syncthreads();
      if (with_db) sum_db(db, zs, 16);
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        const int e = e0 + threadIdx.x + i * kWThreads;
        if (e >= outs) break;
        const int co = e / jb.cin, ci = e % jb.cin;
        float s = 0.f;
#pragma unroll 4
        for (int p = 0; p < kTH * kTW; ++p)
          s = fmaf(zs[p * 16 + co], fs[((p / kTW + ty) * kFW + p % kTW + tx) * jb.cin + ci], s);
        acc[i] += s;
      }
    }
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int e = e0 + threadIdx.x + i * kWThreads;
      if (e >= outs) break;
      const int co = e / jb.cin, ci = e % jb.cin;
      out[((size_t)(jb.co0 + co) * jb.cin + ci) * 9 + jb.tap] = acc[i];
    }
    if (with_db) db_partial[(size_t)blockIdx.y * 4 * gc + jb.j * gc + jb.co0 + threadIdx.x] = db;
  }
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
// weight chain packed for the dtype (bf16 chain order at growth depth
// `depth`, as kernel A's, or f32 tap-major, depth ignored);
// `z` (N x H x W x (nf + 4*gc)), `partial` (splits x the weight count) and
// `db_partial` (splits x 4*gc) are scratch; dw is [dW_1 .. dW_5], each OIHW,
// and db the growth convs' [db_1 .. db_4], both f32. bf16 reads the dW plan:
// `jobs` (njobs x kJobInts ints, each job's input channels at most kMaxCic)
// and `bounds` (splits + 1 ints, each split's pixel tiles); f32 ignores them.
// Returns a cudaError_t value; 0 is success.
extern "C" int climsr_rdb_bwd(const void* feat, const void* g, const void* w, void* dx, void* z, float* partial,
                              float* db_partial, float* dw, float* db, const int* jobs, const int* bounds, int njobs,
                              int n, int h, int w_, int nf, int gc, int th, int tw, int depth, int splits,
                              float gy_scale, float gx_scale, int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w_ < 1 || th < 1 || tw < 1 || n > 65535 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (nf % 16 || gc % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = nf + 4 * gc;
  const dim3 grid((w_ + tw - 1) / tw, (h + th - 1) / th, n);
  cudaError_t err;
  if (is_bf16) {
    if (!chain_fits(nf, gc, th, tw, depth) || jobs == nullptr || bounds == nullptr || njobs < total / 16)
      return (int)cudaErrorInvalidValue;
    const size_t smem = chain_smem(nf, gc, th, tw);
    using Kernel = decltype(&rdb_bwd_dx_bf16_kernel<1, false>);
    const Kernel kernels[2][kMaxGrowthQ] = {
        {&rdb_bwd_dx_bf16_kernel<1, false>, &rdb_bwd_dx_bf16_kernel<2, false>, &rdb_bwd_dx_bf16_kernel<3, false>},
        {&rdb_bwd_dx_bf16_kernel<1, true>, &rdb_bwd_dx_bf16_kernel<2, true>, &rdb_bwd_dx_bf16_kernel<3, true>}};
    const Kernel dx_kernel = kernels[nf != kLastN][gc / 16 - 1];
    if ((err = allow_smem(dx_kernel, smem)) != cudaSuccess) return (int)err;
    dx_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(g), static_cast<const bf16*>(feat), static_cast<bf16*>(dx), static_cast<bf16*>(z),
        static_cast<const bf16*>(w), h, w_, nf, gc, th, tw, gy_scale, gx_scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const size_t wsmem = 2 * (size_t)wgrad_stage_elems(total < kMaxCic ? total : kMaxCic) * sizeof(bf16);
    if ((err = allow_smem(rdb_wgrad_bf16_kernel, wsmem)) != cudaSuccess) return (int)err;
    rdb_wgrad_bf16_kernel<<<njobs * splits, kThreads, wsmem, s>>>(static_cast<const bf16*>(z),
                                                                   static_cast<const bf16*>(feat), jobs, bounds,
                                                                   partial, db_partial, njobs, h, w_, nf, gc);
  } else {
    const dim3 wgrid(9 * (4 * (gc / 16) + nf / 16), splits);
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
