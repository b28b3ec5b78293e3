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
// g is N x H x W x cout (channels_last), in bf16 or f32; the weights come as
// f32 (rounded to the compute type first, as the TPU kernel reads them), the
// sums are f32 and the output is rounded once to g's type.
//
// Bound on this card: at the training shape (192 x 64 x 128 x 128, bf16) the
// kernel must read 403 MB of g (120 us at 3.35 TB/s) and do 16.3 G multiply-
// adds (33 us on the tensor cores, 490 us on the f32 CUDA cores). It is bound
// by memory only if the products run on the tensor cores.
//
// Design (first version, CUDA cores): each block owns a 32 x 32 output tile of
// one image and walks the cout channels in chunks of 16. It stages a chunk of
// g with a 4-pixel halo (40 x 40 pixels) in shared memory as channel-major
// planes (so neighbouring threads read neighbouring pixels) and the spatially
// flipped weights of that chunk. Each thread computes 4 horizontally adjacent
// outputs: per channel and filter row it reads 12 inputs and 9 weights and
// does 36 f32 multiply-adds. g is read from device memory once (plus the
// halo, 1.56x at 32 x 32), the output written once. The f32 multiply-adds
// make it compute-bound at about 4x its bound; moving the channel sum to the
// tensor cores (project each pixel's 64 channels onto the 81 taps, then
// shift-add, as the TPU kernel does) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kT = 32;            // output tile: 32 x 32 pixels
constexpr int kS = kT + 8;        // staged input tile with a 4-pixel halo
constexpr int kC = 16;            // channels per chunk
constexpr int kPx = 4;            // outputs per thread, along x
constexpr int kThreads = kT * kT / kPx;
constexpr size_t kSmem = (kC * kS * (kS + 1) + kC * 81) * sizeof(float);  // 110 KB: two blocks per SM

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// wf[c][u'][v'] = W[c, 0, 8 - u', 8 - v'] (f32, packed by the wrapper)
template <class T>
__global__ void __launch_bounds__(kThreads)
    conv9_dx_c0_kernel(const T* __restrict__ g, const float* __restrict__ wf, T* __restrict__ out, int H, int W,
                       int cout) {
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
          (gy >= 0 && gy < H && gx >= 0 && gx < W) ? to_f32(g[(img + (size_t)gy * W + gx) * cout + c0 + c]) : 0.f;
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
    if (gx < W) store(out + img + (size_t)gy * W + gx, acc[p]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): g (N x H x W x cout), wf (cout x 81
// f32, flipped), out (N x H x W). Returns a cudaError_t value; 0 is success.
extern "C" int climsr_conv9_dx_c0(const void* g, const float* wf, void* out, int n, int h, int w, int cout,
                                  int is_bf16, void* stream) {
  if (n < 1 || h < 1 || w < 1 || n > 65535 || cout < 1 || cout % kC) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kT - 1) / kT, (h + kT - 1) / kT, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    auto kernel = conv9_dx_c0_kernel<__nv_bfloat16>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem)) != cudaSuccess)
      return (int)err;
    kernel<<<grid, kThreads, kSmem, s>>>(static_cast<const __nv_bfloat16*>(g), wf, static_cast<__nv_bfloat16*>(out),
                                         h, w, cout);
  } else {
    auto kernel = conv9_dx_c0_kernel<float>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem)) != cudaSuccess)
      return (int)err;
    kernel<<<grid, kThreads, kSmem, s>>>(static_cast<const float*>(g), wf, static_cast<float*>(out), h, w, cout);
  }
  return (int)cudaGetLastError();
}
