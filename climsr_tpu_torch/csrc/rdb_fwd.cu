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
// - bfloat16 (`rdb_fwd_bf16_kernel<gc / 16, nf != 64>`, nf a multiple of 16
//   up to 128, gc = 16, 32 or 48, one kernel per growth width and for nf = 64
//   or any other nf): the five convs are `conv_chain` of rdb_common.cuh, implicit GEMMs on the tensor cores with
//   f32 sums (rows: the region's pixels; columns: output channels; K = 9 taps
//   x cin). The buffer is pixel-major, channels padded by 8 so the eight rows
//   of an ldmatrix fall on distinct banks; A fragments come from it with
//   ldmatrix, so a tap is an address offset. The weights (packed once by the
//   wrapper, `chain_index`) stream through a ring of two 18,432-byte slots
//   in shared memory with cp.async, one chunk (16 input channels x 9 taps x
//   64 outputs, or 64 / gc input groups of a growth conv) ahead of the
//   products, so each block reads its 249 KB (gc = 16) or 479 KB (gc = 32)
//   of weights from L2 once. x's copies land with the first chunk. The
//   growth convs (gc outputs) run on mma.sync m16n8k16, each warp holding up
//   to 5 M-tiles of 16 pixels with no branch in the loop, one A fragment
//   feeding gc / 8 n-tiles; conv5 (nf outputs) runs on wgmma m64nNk16 in
//   passes of at most 64 outputs (one pass of N = nf at nf <= 64, two at
//   nf = 80 .. 128), two 64-pixel M-blocks per warpgroup, A from registers and
//   B straight from the ring. wgmma is not used for the growth convs: with 16 or 32 outputs
//   each A fragment feeds few columns, and their time goes to reading A from
//   shared memory, which wgmma would not change.
//   Tile and shared memory (the wrapper's `_tile`, the first that fits):
//   gc = 16, 16 x 16: 36,864 bytes of ring + 26 x 26 x 136 x 2 = 183,872
//   bytes of buffer = 220,736; gc = 32, 8 x 16 (16 x 16 would need 270,400
//   bytes of buffer): 36,864 + 18 x 26 x 200 x 2 = 224,064, ~1.53x halo
//   recompute, conv5 two 64-pixel M-blocks, one per warpgroup (12 x 12 fits
//   too, but its three M-blocks and 25 growth M-tiles ran 12-28% slower in
//   B1 and B2 on an H100); gc = 48, 8 x 8: 207,936. At
//   other nf the same rule picks 16 x 16, 8 x 16, 8 x 8 or, where the buffer
//   is widest (nf = 112 and 128 at gc = 48), 4 x 8. One block of 8 warps per
//   SM of the 232,448 bytes a block may use.
// - float32 (`rdb_fwd_f32_kernel`): CUDA-core FMA over a channel-major buffer,
//   each work item 2 pixels x 8 output channels, weights tap-major
//   [tap][cin][cout] read through L1 (a warp-wide broadcast).
//
// Bound on this card (A): at the inference path's shape (16 tiles of 128 x
// 128, nf=64, gc=16, bf16) one launch needs 65.2 GFLOP against 100 MB of
// traffic, so it is bound by operations (66 us at the tensor cores' dense
// bf16 rate, 30 us of memory). The design keeps every intermediate on chip,
// so the traffic stays at x, x0 and out. What still holds it back (SM clocks
// per block, measured on an H100):
// the growth convs take 58% of a block's time, bound by reading their A
// fragments from shared memory (16 operations per byte); conv5 28%; x's load
// 8% and the epilogue 6%, with nothing to overlap them (one block per SM);
// and the halo recompute, ~1.27x the useful MACs at 16 x 16 tiles. B1 at the
// training shape (192 x 64 x 32 x 32, bf16) needs 48.9 GFLOP (49 us)
// against 126 MB (38 us), so it is bound by operations too. At gc = 32 an
// RDB does 239,616 MAC a pixel (124,416 at gc = 16), so both bounds nearly
// double and stay set by the operations.

#include "rdb_common.cuh"

namespace {

using namespace rdb;

// ---------------------------------------------------------------- bfloat16, tensor cores

// Growth conv k's epilogue: bias, LeakyReLU, round to bf16, into the
// buffer's channel slice nf + k*gc; zero at positions outside the image
// (SAME padding).
struct GrowthStore {
  bf16* feat;
  const float* b;
  int cp, pw, nf, gc, oy, ox, H, W;
  __device__ __forceinline__ void operator()(int k, int sy, int sx, int c, float v0, float v1) const {
    const int gy = oy + sy, gx = ox + sx;
    __nv_bfloat162 r = __floats2bfloat162_rn(0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v0 += b[k * gc + c];
      v1 += b[k * gc + c + 1];
      r = __floats2bfloat162_rn(v0 > 0.f ? v0 : 0.2f * v0, v1 > 0.f ? v1 : 0.2f * v1);
    }
    *reinterpret_cast<__nv_bfloat162*>(feat + (sy * pw + sx) * cp + nf + k * gc + c) = r;
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

// one block per SM: the ring and the buffer take up to 224,064 of the 232,448 bytes a block may use;
// one kernel per growth width gc = 16 * NQ, and per nf = 64 (ANY_NF false) or any other nf
template <int NQ, bool ANY_NF>
__global__ void __launch_bounds__(kThreads, 1)
    rdb_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ x0, bf16* __restrict__ out,
                        bf16* __restrict__ saved, const bf16* __restrict__ w, const float* __restrict__ b, int H,
                        int W, int nf, int gc, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // chain_smem: the ring, then the buffer
  const int ph = th + 2 * kHalo, pw = tw + 2 * kHalo, cp = nf + 4 * gc + kPad;
  bf16* feat = ring + 2 * kSlotElems;
  const int oy = blockIdx.y * th - kHalo;  // image coordinates of buffer pixel (0, 0)
  const int ox = blockIdx.x * tw - kHalo;
  const size_t img = (size_t)blockIdx.z * H * W;

  // x with its halo, 8 channels (16 bytes) at a time, zero outside the image;
  // its copies land together with the first weight chunk
  const int vecs = nf / 8;
  for (int i = threadIdx.x; i < ph * pw * vecs; i += kThreads) {
    const int v = i % vecs, pix = i / vecs;
    const int gy = oy + pix / pw, gx = ox + pix % pw;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(feat + pix * cp + v * 8, inside ? x + (img + (size_t)gy * W + gx) * nf + v * 8 : x, inside);
  }

  const GrowthStore growth{feat, b, cp, pw, nf, gc, oy, ox, H, W};
  const ResidualStore last{feat, x0, out, b + 4 * gc, img, cp, pw, oy, ox, H, W, nf};
  conv_chain<NQ, ANY_NF>(feat, ring, w, nf, gc, pw, th, tw, growth, last, [&] {
    if (saved == nullptr) return;
    // B1: the tile's [x, h_1 .. h_4] to device memory, 16 bytes at a time
    const int total = nf + 4 * gc, tv = total / 8;
    for (int i = threadIdx.x; i < th * tw * tv; i += kThreads) {
      const int v = i % tv, pix = i / tv, sy = pix / tw, sx = pix % tw;
      const int gy = oy + kHalo + sy, gx = ox + kHalo + sx;
      if (gy < H && gx < W)
        *reinterpret_cast<uint4*>(saved + (img + (size_t)gy * W + gx) * total + v * 8) =
            *reinterpret_cast<const uint4*>(feat + ((kHalo + sy) * pw + kHalo + sx) * cp + v * 8);
    }
  });
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
    if (!chain_fits(nf, gc, th, tw)) return (int)cudaErrorInvalidValue;
    using Kernel = decltype(&rdb_fwd_bf16_kernel<1, false>);
    const Kernel kernels[2][kMaxGrowthQ] = {
        {&rdb_fwd_bf16_kernel<1, false>, &rdb_fwd_bf16_kernel<2, false>, &rdb_fwd_bf16_kernel<3, false>},
        {&rdb_fwd_bf16_kernel<1, true>, &rdb_fwd_bf16_kernel<2, true>, &rdb_fwd_bf16_kernel<3, true>}};
    return launch<Kernel, bf16, bf16>(kernels[nf != kLastN][gc / 16 - 1], chain_smem(nf, gc, th, tw), x, x0, out,
                                      saved, w, b, n, h, w_, nf, gc, th, tw, s);
  }
  if (nf % kQ || gc % kQ || tw % kP) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(nf + 4 * gc) * (th + 2 * kHalo) * (tw + 2 * kHalo) * sizeof(float);
  return launch<decltype(&rdb_fwd_f32_kernel), float, float>(&rdb_fwd_f32_kernel, smem, x, x0, out, saved, w, b, n,
                                                             h, w_, nf, gc, th, tw, s);
}

}  // namespace

// Plain C entry points (bound with ctypes). `w` is the wrapper's packing for
// the dtype: bf16 chain order (is_bf16) or f32 tap-major. Each returns a
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
