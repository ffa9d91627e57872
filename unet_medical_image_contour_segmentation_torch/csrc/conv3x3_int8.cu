// int8 3x3 stride-1 SAME convolution on NHWC tensors, summed exactly in int32
// on the tensor cores, with the int8 serving path's epilogue fused in.
//
// Replaces XLA ops of the JAX package, not a Pallas kernel: the int8 conv
// ops/wide.py:conv_wide_int8 (:255-307) and its split-input form
// conv_wide_split_int8 (:309-326), and the epilogue of
// models/quantize.py:_qconv (:65-82).  Per output element
//
//   acc = sum_{u,v,ci} x[b,h+u-1,w+v-1,ci] * W[co,u,v,ci]       (int32, exact)
//   yf  = max(fp32(acc) * mul[co] + badd[co], 0)                 (two roundings)
//   y   = requant: clip(round_half_even(yf), 0, 127) -> int8
//         dequant: yf -> f32 or bf16 (one rounding of the same f32)
//
// zero padded.  x is int8 (B, H, W, Cin), any B, H, W, and Cin a multiple
// of 16 (kernels/conv3x3_int8.py pads other Cin with zero channels); y is
// (B, H, W, Cout), Cout >= 1.  The weight is packed once, when the int8
// parameters are built, as (Cout, 9, Cin_p) int8 with Cin_p = Cin rounded up
// to 32 and zeros past Cin: for each output channel its K = 9 * Cin_p values
// run contiguously, the "col" (K-major) layout of the MMA's B operand.  The
// epilogue multiplies and adds with __fmul_rn / __fadd_rn, so nvcc cannot
// contract them into one FMA: the result is bit-equal to the plain version's
// separate f32 multiply and add (kernels/conv3x3_int8.py).
//
// Bound.  At unet_s's shapes the int8 conv moves half the bytes of the bf16
// one and the tensor cores run int8 at twice the bf16 rate (1,979 TOPS dense
// against 989 TFLOP/s on the H100): the levels with Cin >= 64 at <= 64^2 are
// bound by operations, the rest by bytes.
//
// Design: a simple kernel that is right first.  An implicit GEMM on
// mma.sync.m16n8k32 s8 x s8 -> s32, M = pixels, N = Cout, K = 9 * Cin.
//   - A block of 4 warps owns an 8x32 tile of output pixels and a chunk of
//     N_p = 8, 16, 32 or 64 output channels; the grid walks chunks of 64
//     beyond (each chunk restages the halo).
//   - K runs over Cin in chunks of 32 bytes (one k32 step), and over the 9
//     taps inside a chunk.  Per chunk the block stages the 10x34 halo tile
//     (32 channels a pixel) and the chunk's weight (N_p rows of 9 x 32) in
//     shared memory, double-buffered: the next chunk's cp.async copies run
//     while the tensor cores work on this one.  Cin up to 1024 (unet's
//     up1.conv1) thus needs no more shared memory than Cin = 32.
//   - The halo is staged with 16-byte cp.async copies, zero-filled
//     (src-size 0) outside the image and past Cin, so x must have Cin a
//     multiple of 16 and a 16-byte aligned base: the wrapper pads other
//     Cin with zero channels (inc.conv1's Cin = 1 to 16), which the packed
//     weight's zero rows then multiply.
//   - Halo pixels lie 48 bytes apart and weight rows 304 bytes apart, odd
//     multiples of 16 bytes: the 8 row addresses of one ldmatrix phase fall
//     into 8 distinct groups of 4 banks.
//   - int8 fragments have the bf16 ones' shape in 32-bit words, so
//     ldmatrix.x4 (b16) loads A (16 pixels x 32 channels) and, without .trans,
//     B (two n8 tiles x 32 k, rows are output channels).
//   - Epilogue in registers on the s32 fragments, scalar stores guarded at
//     the image edge and at Cout.
// wgmma s8 with TMA halo boxes is a later redesign.
//
// The host side opts each kernel into the largest dynamic shared memory
// once per device and returns cudaGetLastError() after each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int SMEM_OPT_IN = 232448;  // the most a block may use on sm_90
constexpr int MAX_DEVICES = 64;

constexpr int TH = 8;                  // output rows per block
constexpr int TW = 32;                 // output columns per block
constexpr int WARPS = 4;               // each owns 2 rows x 32 columns
constexpr int THREADS = 32 * WARPS;
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;
constexpr int M_TILES = 4;             // m16 tiles per warp
constexpr int KC = 32;                 // input channels per K chunk (one k32 step)
constexpr int PS = 48;                 // halo pixel stride, bytes: 3 x 16
constexpr int WROW = 9 * KC + 16;      // weight row stride, bytes: 19 x 16

enum OutKind { OUT_INT8 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

__host__ __device__ constexpr int cin_padded(int cin) { return (cin + KC - 1) / KC * KC; }

// n8 tiles per block: the fewest of 1, 2, 4, 8 that hold Cout (8 = 64 channels).
int n_tiles_for(int cout) { return cout <= 8 ? 1 : cout <= 16 ? 2 : cout <= 32 ? 4 : 8; }

size_t stage_bytes(int n_tiles) { return (size_t)HALO_PX * PS + (size_t)8 * n_tiles * WROW; }
size_t smem_bytes(int n_tiles) { return 2 * stage_bytes(n_tiles); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past src_bytes (0 or 16) are zeros.
// .cg for the halo (L2 only), .ca for the weight (every block reads it).
__device__ __forceinline__ void cp_async16_cg(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += a * b: A 16x32 row-major, B 32x8 column-major, s8 in, s32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage K chunk `c` (input channels c*32 .. +31) into one buffer: the halo
// tile [HALO_PX][PS] and the weight chunk [NP][WROW] (row n: tap t at t*32).
template <int NP>
__device__ __forceinline__ void stage_chunk(unsigned char* halo, unsigned char* wsm,
                                            const int8_t* __restrict__ xb,
                                            const int8_t* __restrict__ w, int c, int H, int W,
                                            int h0, int w0, int cin, int cinp, int co0,
                                            int cout) {
  const int tid = threadIdx.x;
  const int k0 = c * KC;
  // cin % 16 == 0: two 16-byte pieces per pixel, each all data or all zero
  for (int i = tid; i < HALO_PX * 2; i += THREADS) {
    const int p = i >> 1, j = i & 1;
    const int gh = h0 - 1 + p / HALO_W, gw = w0 - 1 + p % HALO_W;
    const bool ok = k0 + j * 16 < cin && gh >= 0 && gh < H && gw >= 0 && gw < W;
    const int8_t* src = ok ? xb + ((int64_t)gh * W + gw) * cin + k0 + j * 16 : xb;
    cp_async16_cg(smem_addr(halo + p * PS + j * 16), src, ok ? 16 : 0);
  }
  // weight: NP rows x 9 taps x two 16-byte pieces; rows past cout are zero
  for (int i = tid; i < NP * 18; i += THREADS) {
    const int n = i / 18, r = i % 18, t = r >> 1, j = r & 1;
    const bool ok = co0 + n < cout;
    const int8_t* src = ok ? w + ((int64_t)(co0 + n) * 9 + t) * cinp + k0 + j * 16 : w;
    cp_async16_ca(smem_addr(wsm + n * WROW + t * KC + j * 16), src, ok ? 16 : 0);
  }
}

template <int NT, int OUT>
__global__ void __launch_bounds__(THREADS)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ mul, const float* __restrict__ badd,
                    void* __restrict__ y, int H, int W, int cin, int cout, int n_chunks) {
  constexpr int NP = 8 * NT;
  constexpr size_t STAGE = (size_t)HALO_PX * PS + (size_t)NP * WROW;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.z / n_chunks;
  const int co0 = (blockIdx.z % n_chunks) * NP;
  const int h0 = blockIdx.y * TH;
  const int w0 = blockIdx.x * TW;
  const int cinp = cin_padded(cin);
  const int n_k = cinp / KC;
  const int8_t* xb = x + (int64_t)b * H * W * cin;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int acc[M_TILES][NT][4];
#pragma unroll
  for (int mt = 0; mt < M_TILES; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  // A: m tile mt covers output row 2*warp + mt/2, columns (mt%2)*16 .. +15;
  // lane gives the address of pixel lane%16, channels (lane/16)*16 .. +15
  uint32_t a_off[M_TILES];
#pragma unroll
  for (int mt = 0; mt < M_TILES; ++mt)
    a_off[mt] = ((2 * warp + mt / 2) * HALO_W + (mt % 2) * 16 + (lane & 15)) * PS +
                (lane >> 4) * 16;
  // B (x4): lane gives matrix lane/8 = (n tile half, k half): output channel
  // row (lane%8) + ((lane/16)%2)*8, k bytes ((lane/8)%2)*16 .. +15, so the
  // four registers are b0, b1 of n tile 2*np and b0, b1 of n tile 2*np+1
  const uint32_t b_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * WROW + ((lane >> 3) & 1) * 16;

  stage_chunk<NP>(smem, smem + HALO_PX * PS, xb, w, 0, H, W, h0, w0, cin, cinp, co0, cout);
  cp_async_commit();
  for (int c = 0; c < n_k; ++c) {
    unsigned char* buf = smem + (c & 1) * STAGE;
    if (c + 1 < n_k) {
      unsigned char* nxt = smem + ((c + 1) & 1) * STAGE;
      stage_chunk<NP>(nxt, nxt + HALO_PX * PS, xb, w, c + 1, H, W, h0, w0, cin, cinp, co0, cout);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t halo_s = smem_addr(buf);
    const uint32_t w_s = smem_addr(buf + HALO_PX * PS);
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int t = u * 3 + v;
        uint32_t bf[NT][2];
        if constexpr (NT == 1) {
          ldmatrix_x2(bf[0][0], bf[0][1], w_s + b_off + t * KC);
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t r[4];
            ldmatrix_x4(r, w_s + b_off + np * 16 * WROW + t * KC);
            bf[2 * np][0] = r[0];
            bf[2 * np][1] = r[1];
            bf[2 * np + 1][0] = r[2];
            bf[2 * np + 1][1] = r[3];
          }
        }
        const uint32_t a_tap = (u * HALO_W + v) * PS;
#pragma unroll
        for (int mt = 0; mt < M_TILES; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, halo_s + a_off[mt] + a_tap);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is restaged
  }

  // epilogue: lane holds (pixel g, channels 2q, 2q+1) and pixel g+8 per tile
  const int g = lane >> 2, q = lane & 3;
  float mv[NT][2], bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + nt * 8 + 2 * q + e;
      mv[nt][e] = co < cout ? mul[co] : 0.f;
      bv[nt][e] = co < cout ? badd[co] : 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < M_TILES; ++mt) {
    const int gh = h0 + 2 * warp + mt / 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gw = w0 + (mt % 2) * 16 + g + half * 8;
      if (gh >= H || gw >= W) continue;
      const int64_t pix = ((int64_t)b * H + gh) * W + gw;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + nt * 8 + 2 * q + e;
          if (co >= cout) continue;
          float yf = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + e]), mv[nt][e]),
                               bv[nt][e]);
          yf = fmaxf(yf, 0.f);
          if constexpr (OUT == OUT_INT8) {
            const int r = min(max(__float2int_rn(yf), 0), 127);
            static_cast<int8_t*>(y)[pix * cout + co] = static_cast<int8_t>(r);
          } else if constexpr (OUT == OUT_F32) {
            static_cast<float*>(y)[pix * cout + co] = yf;
          } else {
            static_cast<__nv_bfloat16*>(y)[pix * cout + co] = __float2bfloat16_rn(yf);
          }
        }
    }
  }
}

template <int NT, int OUT>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(conv3x3_int8_kernel<NT, OUT>);
}

// f(std::integral_constant<int, NT>) for the instantiation that serves cout.
template <typename F>
auto with_n_tiles(int cout, F f) {
  switch (n_tiles_for(cout)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

// Once per device: allow every instantiation the largest dynamic shared memory.
cudaError_t opt_in_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const void* kernels[] = {
      kernel_ptr<1, OUT_INT8>(), kernel_ptr<2, OUT_INT8>(), kernel_ptr<4, OUT_INT8>(),
      kernel_ptr<8, OUT_INT8>(), kernel_ptr<1, OUT_F32>(),  kernel_ptr<2, OUT_F32>(),
      kernel_ptr<4, OUT_F32>(),  kernel_ptr<8, OUT_F32>(),  kernel_ptr<1, OUT_BF16>(),
      kernel_ptr<2, OUT_BF16>(), kernel_ptr<4, OUT_BF16>(), kernel_ptr<8, OUT_BF16>(),
  };
  for (const void* kernel : kernels) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
    if (err != cudaSuccess) return err;
  }
  if (dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

template <int NT, int OUT>
int launch(const void* x, const void* w, const void* mul, const void* badd, void* y, int B,
           int H, int W, int cin, int cout, cudaStream_t stream) {
  const cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (cout + 8 * NT - 1) / (8 * NT);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_chunks);
  conv3x3_int8_kernel<NT, OUT><<<grid, THREADS, smem_bytes(NT), stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(badd), y, H, W, cin, cout,
      n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  out_kind: 0 = int8 (requant), 1 = f32,
// 2 = bf16 (dequant).  A launch returns its cudaError_t (0 = success).  x and
// the weight must be 16-byte aligned and Cin a multiple of 16 (the wrapper
// pads x's channels).
extern "C" int conv3x3_int8_nhwc(const void* x, const void* w, const void* mul, const void* badd,
                                 void* y, int B, int H, int W, int cin, int cout, int out_kind,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (cin % 16 != 0) return (int)cudaErrorInvalidValue;
  return with_n_tiles(cout, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    switch (out_kind) {
      case OUT_INT8: return launch<NT, OUT_INT8>(x, w, mul, badd, y, B, H, W, cin, cout, s);
      case OUT_F32: return launch<NT, OUT_F32>(x, w, mul, badd, y, B, H, W, cin, cout, s);
      case OUT_BF16: return launch<NT, OUT_BF16>(x, w, mul, badd, y, B, H, W, cin, cout, s);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

extern "C" const char* conv3x3_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
