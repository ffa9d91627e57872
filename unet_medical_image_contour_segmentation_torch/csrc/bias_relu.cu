// Bias add and ReLU of a conv's NHWC output in one pass:
//
//   out[b,h,w,c] = max(round(float(y[b,h,w,c]) + float(bias[c])), 0)
//
// rounded once to y's type (bf16 or f32), NaN passed on.  That is what
// torch.relu(y + bias) computes on the card in two kernels (the add in f32,
// rounded to y's type; then clamp_min, which returns a NaN as it is), so the
// served class maps stay equal bit for bit.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the bias and the ReLU into
// the conv's output.  The port's served forward (the BN-folded DoubleConv,
// models/fold_bn.py) ran them as two elementwise passes after every 3x3
// conv, and the bias add, broadcast along the last dimension, fell to
// PyTorch's non-vectorised kernel.
//
// Bound: bytes.  The pass reads y and writes out once (the bias is C values
// read once per block), with one add and one max per element.  Its design
// for that:
//   - 16-byte loads and stores when C is a multiple of 8 (bf16) or 4 (f32)
//     and both tensors are 16-byte aligned: each vector is 8 or 4
//     consecutive channels of one pixel.  Otherwise a scalar loop of the
//     same arithmetic.  The host picks the loop from the shape and the
//     pointers.
//   - The block stages the bias in shared memory as f32, once (C <= 12288:
//     48 KB).
//   - Each thread issues U = 4 loads of 16 bytes before its first store.
//     A block takes a tile of 4 x 256 vectors (16 KB of bf16 in, 16 KB
//     out), one tile per block up to 2**16 blocks: the card's scheduler
//     then spreads the tiles over the SMs as they free up, with no wave of
//     blocks left half full.  Past that, a grid-stride loop with 64-bit
//     offsets.  A thread's channel advances by the stride modulo C, with no
//     division in the loop.
//
// The host side launches on the caller's stream (on the tensors' device,
// the current one restored after), synchronises nothing, allocates
// nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;                   // vectors a thread has in flight
constexpr int TILE = U * THREADS;      // vectors a block takes a step
constexpr int MAX_BLOCKS = 1 << 16;    // one tile a block up to 2**26 vectors
constexpr int MAX_C = 12288;           // 48 KB of f32 bias: dynamic shared memory without opt-in

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch.relu(y + b) element for element: the sum rounded to T, then
// clamp_min(., 0) in f32 on the rounded value, a NaN returned as it is.
template <typename T>
__device__ __forceinline__ T bias_relu(T y, float b) {
  const T s = from_float<T>(to_float(y) + b);
  const float v = to_float(s);
  return isnan(v) ? s : from_float<T>(fmaxf(v, 0.0f));
}

// The U vectors of the thread's tile at i (those below n_vec) into v.
template <typename T, int V>
__device__ __forceinline__ void load_tile(const T* __restrict__ y, int64_t i, int64_t n_vec,
                                          T (&v)[U][V]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t k = i + u * THREADS;
    if (k >= n_vec) break;
    if constexpr (V * sizeof(T) == 16) {
      // y is read once: evict it first
      *reinterpret_cast<uint4*>(v[u]) = __ldcs(reinterpret_cast<const uint4*>(y) + k);
    } else {
      v[u][0] = y[k];
    }
  }
}

// V elements of T a vector: V * sizeof(T) == 16 takes 16-byte loads and
// stores, V == 1 the scalar loop.  A block walks tiles of U * THREADS
// vectors: thread t takes vectors t, t + THREADS, ... of its tile, all U
// loads issued before the first store.  The first tile's loads are issued
// before the bias is staged, so the staging hides under them.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bias_relu_kernel(const T* __restrict__ y, const T* __restrict__ bias, T* __restrict__ out,
                 int64_t n_vec, int c) {
  int64_t i = (int64_t)blockIdx.x * TILE + threadIdx.x;
  alignas(16) T v[U][V];
  load_tile(y, i, n_vec, v);

  extern __shared__ float b_s[];  // c values
  for (int j = threadIdx.x; j < c; j += THREADS) b_s[j] = to_float(bias[j]);
  __syncthreads();

  const int c_vec = c / V;  // vectors a pixel
  const int64_t stride = (int64_t)gridDim.x * TILE;
  const int step = (int)(stride % c_vec);
  int cv[U];  // the first channel / V of each of the thread's U vectors
  cv[0] = (int)(i % c_vec);
#pragma unroll
  for (int u = 1; u < U; ++u) {
    cv[u] = cv[u - 1] + THREADS % c_vec;
    if (cv[u] >= c_vec) cv[u] -= c_vec;
  }
  while (i < n_vec) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t k = i + u * THREADS;
      if (k >= n_vec) break;
      const float* bp = b_s + cv[u] * V;
#pragma unroll
      for (int j = 0; j < V; ++j) v[u][j] = bias_relu(v[u][j], bp[j]);
      if constexpr (V * sizeof(T) == 16) {
        reinterpret_cast<uint4*>(out)[k] = *reinterpret_cast<const uint4*>(v[u]);
      } else {
        out[k] = v[u][0];
      }
    }
    i += stride;
    load_tile(y, i, n_vec, v);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cv[u] += step;
      if (cv[u] >= c_vec) cv[u] -= c_vec;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int V>
int launch_v(const T* y, const T* bias, T* out, int64_t n_vec, int c, cudaStream_t stream) {
  const int64_t tiles = (n_vec + TILE - 1) / TILE;
  const int blocks = (int)(tiles < MAX_BLOCKS ? tiles : MAX_BLOCKS);
  bias_relu_kernel<T, V><<<blocks, THREADS, c * sizeof(float), stream>>>(y, bias, out, n_vec, c);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* y, const void* bias, void* out, long long n, int c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (n < 0 || c < 1 || c > MAX_C || n % c) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const T* yp = static_cast<const T*>(y);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  if (c % V == 0 && aligned16(y) && aligned16(out))
    return launch_v<T, V>(yp, bp, op, n / V, c, stream);
  return launch_v<T, 1>(yp, bp, op, n, c, stream);
}

// The launch on `device`, the caller's current device restored after it.
template <typename T>
int launch_on(int device, const void* y, const void* bias, void* out, long long n, int c,
              void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int status = launch<T>(y, bias, out, n, c, static_cast<cudaStream_t>(stream));
  if (prev != device) err = cudaSetDevice(prev);
  return status ? status : (int)err;
}

}  // namespace

// Plain C interface for ctypes.  y and out hold n elements, C channels
// innermost (n a multiple of C); bias holds C; all three and `stream` lie on
// `device`.  A launch returns its cudaError_t (0 = success).
extern "C" int bias_relu_nhwc_bf16(const void* y, const void* bias, void* out, long long n, int c,
                                   int device, void* stream) {
  return launch_on<__nv_bfloat16>(device, y, bias, out, n, c, stream);
}

extern "C" int bias_relu_nhwc_f32(const void* y, const void* bias, void* out, long long n, int c,
                                  int device, void* stream) {
  return launch_on<float>(device, y, bias, out, n, c, stream);
}

extern "C" const char* bias_relu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
