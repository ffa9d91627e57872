// 3x3 stride-1 SAME convolution on NHWC tensors, f32 accumulation.
//
// Replaces the TPU kernel ops/pallas_conv.py:conv_s2d_b4_im2col of the JAX
// package (pallas_call at :133, body _kernel at :72-123).  That kernel works
// on a space-to-depth-4 tensor only to dodge the TPU's (8, 128) memory
// tiling; on Hopper the same function is computed on plain NHWC with
// 8 <= Cin <= 64, any Cout >= 1, any H and W (the ragged edge is masked here).
//
//   y[b,h,w,co] = sum_{u,v,ci} x[b,h+u-1,w+v-1,ci] * W[u,v,ci,co]
//
// The same entry computes the input gradient of such a conv (the TPU
// kernel's custom VJP, pallas_conv.py:178-183): dx is this conv of the
// output gradient with the weight rotated 180 degrees and its in/out
// channels swapped, so the forward's Cout (up to 64 in unet_s) is dx's Cin.
// At Cin = 64 a block stages 37 KB of f32 weights plus the halo tile,
// 80 KB in bf16 and 159 KB in f32: under the 227 KB opt-in, one f32 block
// per SM.
//
// x is (B, H, W, Cin), the weight is the HWIO kernel packed as a (9*Cin, Cout)
// matrix (row (u*3+v)*Cin + ci), y is (B, H, W, Cout); all three share one
// dtype (bf16 or f32).  No bias, as in the TPU kernel: bias and ReLU are
// added outside.
//
// Bound.  Reading x once and writing y once at 3.35 TB/s; at the unet_s
// shapes this is a memory-bound function (9*Cin*Cout MACs per pixel is
// far below the card's ~295 operations per byte).
//
// Design (the simple first version; tensor cores, TMA and a fused
// bias+ReLU epilogue are later work).  One block per (batch image, 16x32
// output tile, chunk of 16 output channels).  The block stages the 18x34
// halo tile (zero outside the image) and its weight chunk in shared memory.
// Each of the 128 threads owns one output column and 4 rows, and keeps the
// 4x16 partial sums in f32 registers: per (tap, ci) it reads 4 activations
// and 16 weights (a broadcast float4 read) for 64 FMAs on the CUDA cores.
// The halo's per-pixel channel stride is an odd number of 32-bit words, so
// the 32 lanes of a warp (32 neighbouring columns) hit 32 distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;                   // output rows per block
constexpr int TW = 32;                   // output columns per block (one per lane)
constexpr int PX = 4;                    // output rows per thread
constexpr int CO = 16;                   // output channels per block
constexpr int THREADS = (TH / PX) * TW;  // 128
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements between two halo pixels in shared memory: an odd count of words.
template <typename T>
__host__ __device__ inline int halo_stride(int cin) {
  int words = (cin * (int)sizeof(T) + 3) / 4;
  words |= 1;
  return words * 4 / (int)sizeof(T);
}

template <typename T>
size_t smem_bytes(int cin) {
  return (size_t)9 * cin * CO * sizeof(float) + (size_t)HALO_PX * halo_stride<T>(cin) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int H, int W, int cin, int cout, int n_co) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);  // [9*cin][CO]
  T* x_s = reinterpret_cast<T*>(smem + (size_t)9 * cin * CO * sizeof(float));
  const int S = halo_stride<T>(cin);

  const int b = blockIdx.z / n_co;
  const int co0 = (blockIdx.z % n_co) * CO;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  // weight chunk, zero past cout
  for (int i = tid; i < 9 * cin * CO; i += THREADS) {
    const int k = i / CO, j = i % CO;
    const int co = co0 + j;
    w_s[i] = co < cout ? to_f32(w[(int64_t)k * cout + co]) : 0.f;
  }
  // halo tile, zero outside the image (SAME padding and the ragged edge)
  const T* xb = x + (int64_t)b * H * W * cin;
  for (int i = tid; i < HALO_PX * cin; i += THREADS) {
    const int p = i / cin, ci = i % cin;
    const int gh = h0 - 1 + p / HALO_W, gw = w0 - 1 + p % HALO_W;
    T v = from_f32<T>(0.f);
    if (gh >= 0 && gh < H && gw >= 0 && gw < W) v = xb[((int64_t)gh * W + gw) * cin + ci];
    x_s[p * S + ci] = v;
  }
  __syncthreads();

  const int col = tid % TW;
  const int row0 = (tid / TW) * PX;
  float acc[PX][CO];
#pragma unroll
  for (int r = 0; r < PX; ++r)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[r][j] = 0.f;

  for (int u = 0; u < 3; ++u) {
    for (int v = 0; v < 3; ++v) {
      const T* xp = x_s + ((row0 + u) * HALO_W + col + v) * S;
      const float4* wp = reinterpret_cast<const float4*>(w_s + (u * 3 + v) * cin * CO);
#pragma unroll 4
      for (int ci = 0; ci < cin; ++ci) {
        float xv[PX];
#pragma unroll
        for (int r = 0; r < PX; ++r) xv[r] = to_f32(xp[r * HALO_W * S + ci]);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
          const float4 wv = wp[ci * (CO / 4) + q];
#pragma unroll
          for (int r = 0; r < PX; ++r) {
            acc[r][4 * q + 0] = fmaf(xv[r], wv.x, acc[r][4 * q + 0]);
            acc[r][4 * q + 1] = fmaf(xv[r], wv.y, acc[r][4 * q + 1]);
            acc[r][4 * q + 2] = fmaf(xv[r], wv.z, acc[r][4 * q + 2]);
            acc[r][4 * q + 3] = fmaf(xv[r], wv.w, acc[r][4 * q + 3]);
          }
        }
      }
    }
  }

  const int gw = w0 + col;
  if (gw >= W) return;
#pragma unroll
  for (int r = 0; r < PX; ++r) {
    const int gh = h0 + row0 + r;
    if (gh >= H) continue;
    T* yp = y + (((int64_t)b * H + gh) * W + gw) * cout + co0;
#pragma unroll
    for (int j = 0; j < CO; ++j)
      if (co0 + j < cout) yp[j] = from_f32<T>(acc[r][j]);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int B, int H, int W, int cin, int cout,
           void* stream) {
  const size_t smem = smem_bytes<T>(cin);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_co = (cout + CO - 1) / CO;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_co);
  conv3x3_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), H, W, cin, cout,
      n_co);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Returns the launch's cudaError_t (0 = success).
extern "C" int conv3x3_nhwc_bf16(const void* x, const void* w, void* y, int B, int H, int W,
                                 int cin, int cout, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, B, H, W, cin, cout, stream);
}

extern "C" int conv3x3_nhwc_f32(const void* x, const void* w, void* y, int B, int H, int W,
                                int cin, int cout, void* stream) {
  return launch<float>(x, w, y, B, H, W, cin, cout, stream);
}

extern "C" const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
