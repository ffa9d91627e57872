// 3x3 stride-1 SAME convolution on NHWC tensors: bf16 on the tensor cores,
// f32 on the CUDA cores, both summed in f32 and rounded once.
//
// Replaces the TPU kernel ops/pallas_conv.py:conv_s2d_b4_im2col of the JAX
// package (pallas_call at :133, body _kernel at :72-123) and the dx of its
// custom VJP (_bwd_rule, :178-183).  That kernel works on a space-to-depth-4
// tensor only to dodge the TPU's (8, 128) memory tiling; on Hopper the same
// function is computed on plain NHWC:
//
//   y[b,h,w,co] = sum_{u,v,ci} x[b,h+u-1,w+v-1,ci] * W[u,v,ci,co]
//
// zero padded, no bias and no ReLU (added outside, as in the TPU kernel).
// x is (B, H, W, Cin) with 8 <= Cin <= 64, y is (B, H, W, Cout) with any
// Cout >= 1, any B, H and W.  The weight is the HWIO kernel packed as a
// row-major (9*Cin, Cout) matrix, row (u*3+v)*Cin + ci: a contiguous HWIO
// tensor already is this matrix.  dx of such a conv is this conv of the
// output gradient with the weight rotated 180 degrees and its in/out
// channels swapped, so the forward's Cout (up to 64 in unet_s) is dx's Cin.
//
// Bound.  At the unet_s shapes the function is bound by bytes: reading x and
// writing y once at 3.35 TB/s takes 0.203 ms for the 7 convs of a
// (8, 512, 512) forward, while their 67.6 GFLOP take 0.068 ms at the tensor
// cores' 989 TFLOP/s (bf16).  On the CUDA cores (67 TFLOP/s in f32) the same
// work needs 1.0 ms, five times the byte bound: hence the tensor cores.
//
// bf16: conv3x3_mma_kernel, an implicit GEMM with M = pixels, N = Cout,
// K = 9 * Cin.
//   - A block of 4 warps owns an 8x32 tile of output pixels and a chunk of
//     N_p = 8, 16, 32 or 64 output channels: all of Cout up to 64, the grid
//     walks chunks of 64 beyond.  So each halo tile is staged once.
//   - The block stages the 10x34 halo tile, Cin padded with zeros to Cin_p,
//     a multiple of 16, and the chunk's weight, 9*Cin_p rows of N_p columns
//     with zero rows past Cin and zero columns past Cout, in shared memory.
//     A halo row is one contiguous run of NHWC memory: it is copied with
//     16-byte cp.async, zero-filled (src-size 0) outside the image and in
//     the padded channels.  Padding is always written, never left stale:
//     stale bits can be NaN or Inf, and 0 * Inf is NaN.  Every block reads
//     the same weight, so its copy goes through L1 (cp.async.ca): through
//     L2 alone (.cg) the weight reads took more time than the halo's at
//     512x512 (measured on the H100, see PERF.md).
//   - Two halo pixels, or two weight rows, lie an odd number of 16-byte
//     chunks apart, so the 8 row addresses of an ldmatrix fall into 8
//     distinct groups of 4 banks: no bank conflict.
//   - Each warp owns 2 output rows of 32 pixels, four m16 tiles, and all
//     N_p/8 n8 tiles.  Per tap (u, v) and 16-channel step, ldmatrix.x4 loads
//     A (16 consecutive pixels of halo row r+u from column v on, row-major:
//     pixel x channel), ldmatrix.x4.trans loads B for two n8 tiles from the
//     row-major (k, n) weight, and mma.sync.m16n8k16 sums bf16 products in
//     f32 registers.  wgmma is not needed: the kernel is bound by bytes.
//   - Epilogue: round the f32 sums to bf16 once, stage them in shared memory,
//     and store 16-byte chunks: a tile row of NHWC output is contiguous.
//   - Cin or Cout not a multiple of 8, or a pointer not 16-byte aligned,
//     takes 2-byte loads and stores in place of the 16-byte ones.
//
// f32: conv3x3_kernel<float>, the CUDA-core kernel of the first version.
// The tensor cores take f32 only as TF32 (a 10-bit mantissa), and the f32
// callers (the card-vs-CPU checks, the f32 reference predictor) need full
// f32 products.  One block per (image, 16x32 output tile, 16 output
// channels) stages the 18x34 halo tile and its weight chunk in shared
// memory; each thread sums 4 pixels x 16 channels with f32 FMAs.  The halo's
// per-pixel stride is an odd number of 32-bit words, so 32 lanes (32
// neighbouring columns) hit 32 banks.  At Cin = 64 it stages 37 KB of weight
// and 159 KB of halo: one block per SM.
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

cudaError_t opt_in_smem();  // defined below the kernels

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MT_TH = 8;                     // output rows per block
constexpr int MT_TW = 32;                    // output columns per block
constexpr int MT_WARPS = 4;                  // each owns 2 rows x 32 columns
constexpr int MT_THREADS = 32 * MT_WARPS;
constexpr int MT_HALO_W = MT_TW + 2;
constexpr int MT_HALO_PX = (MT_TH + 2) * MT_HALO_W;
constexpr int MT_M_TILES = 4;                // m16 tiles per warp

// Bytes between two rows of `elems` bf16 (a multiple of 8): the row's
// 16-byte chunks, one more if their count is even.
__host__ __device__ constexpr int odd_row_bytes(int elems) { return 16 * ((elems / 8) | 1); }

__host__ __device__ constexpr int cin_padded(int cin) { return (cin + 15) & ~15; }

// n8 tiles per block: the fewest of 1, 2, 4, 8 that hold Cout (8 = 64 channels).
int mma_n_tiles(int cout) { return cout <= 8 ? 1 : cout <= 16 ? 2 : cout <= 32 ? 4 : 8; }

// f(std::integral_constant<int, NT>) for the instantiation that serves cout.
template <typename F>
auto with_n_tiles(int cout, F f) {
  switch (mma_n_tiles(cout)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

size_t mma_smem_bytes(int cin, int n_tiles) {
  const int cinp = cin_padded(cin);
  const int row = odd_row_bytes(8 * n_tiles);
  const size_t staged = (size_t)MT_HALO_PX * odd_row_bytes(cinp) + (size_t)9 * cinp * row;
  const size_t out = (size_t)MT_TH * MT_TW * row;
  return staged > out ? staged : out;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past src_bytes (0 or 16) are zeros.
// .cg caches in L2 only (the halo: read by this block and its neighbours);
// .ca in L1 too (the weight: read by every block on the SM).
__device__ __forceinline__ void cp_async16_cg(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += a * b: A 16x16 row-major, B 16x8 column-major, bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__global__ void __launch_bounds__(MT_THREADS)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ y, int H, int W, int cin, int cout, int n_chunks,
                   int vec_x, int vec_w, int vec_y) {
  constexpr int NP = 8 * NT;                    // output channels per block
  constexpr int WS = odd_row_bytes(NP);         // weight row and output pixel stride
  extern __shared__ __align__(16) unsigned char smem[];
  const int cinp = cin_padded(cin);
  const int PS = odd_row_bytes(cinp);           // halo pixel stride
  unsigned char* halo = smem;                   // [MT_HALO_PX][PS]
  unsigned char* wsm = smem + MT_HALO_PX * PS;  // [9 * cinp][WS], row (u*3+v)*cinp + k

  const int b = blockIdx.z / n_chunks;
  const int co0 = (blockIdx.z % n_chunks) * NP;
  const int h0 = blockIdx.y * MT_TH;
  const int w0 = blockIdx.x * MT_TW;
  const int tid = threadIdx.x;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  // halo tile, zero outside the image and past cin
  const __nv_bfloat16* xb = x + (int64_t)b * H * W * cin;
  if (vec_x) {
    const int cc = cinp / 8, cv = cin / 8;  // 16-byte chunks per pixel: staged, with data
    for (int i = tid; i < MT_HALO_PX * cc; i += MT_THREADS) {
      const int p = i / cc, j = i - p * cc;
      const int gh = h0 - 1 + p / MT_HALO_W, gw = w0 - 1 + p % MT_HALO_W;
      const bool ok = j < cv && gh >= 0 && gh < H && gw >= 0 && gw < W;
      const __nv_bfloat16* src = ok ? xb + ((int64_t)gh * W + gw) * cin + j * 8 : x;
      cp_async16_cg(smem_addr(halo + p * PS + j * 16), src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < MT_HALO_PX * cinp; i += MT_THREADS) {
      const int p = i / cinp, c = i - p * cinp;
      const int gh = h0 - 1 + p / MT_HALO_W, gw = w0 - 1 + p % MT_HALO_W;
      __nv_bfloat16 v = zero;
      if (c < cin && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = xb[((int64_t)gh * W + gw) * cin + c];
      *reinterpret_cast<__nv_bfloat16*>(halo + p * PS + c * 2) = v;
    }
  }
  // weight chunk: rows past cin and columns past cout are zero
  if (vec_w) {
    for (int i = tid; i < 9 * cinp * NT; i += MT_THREADS) {
      const int r = i / NT, j = i % NT;
      const int t = r / cinp, k = r - t * cinp;
      const int co = co0 + j * 8;
      const bool ok = k < cin && co < cout;
      const __nv_bfloat16* src = ok ? w + (int64_t)(t * cin + k) * cout + co : w;
      cp_async16_ca(smem_addr(wsm + r * WS + j * 16), src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < 9 * cinp * NP; i += MT_THREADS) {
      const int r = i / NP, n = i % NP;
      const int t = r / cinp, k = r - t * cinp;
      const int co = co0 + n;
      __nv_bfloat16 v = zero;
      if (k < cin && co < cout) v = w[(int64_t)(t * cin + k) * cout + co];
      *reinterpret_cast<__nv_bfloat16*>(wsm + r * WS + n * 2) = v;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  float acc[MT_M_TILES][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT_M_TILES; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // A: m tile mt covers output row 2*warp + mt/2, columns (mt%2)*16 .. +15;
  // lane gives the address of pixel lane%16, channels (lane/16)*8 .. +7
  uint32_t a_base[MT_M_TILES];
#pragma unroll
  for (int mt = 0; mt < MT_M_TILES; ++mt)
    a_base[mt] = smem_addr(halo) +
                 ((2 * warp + mt / 2) * MT_HALO_W + (mt % 2) * 16 + (lane & 15)) * PS +
                 (lane >> 4) * 16;
  // B: lane gives the address of weight row (lane%8) + ((lane/8)%2)*8,
  // columns (lane/16)*8 .. +7: matrices (k 0-7, n 0-7), (k 8-15, n 0-7),
  // (k 0-7, n 8-15), (k 8-15, n 8-15) = b0, b1 of two n8 tiles
  const uint32_t b_base =
      smem_addr(wsm) + ((lane & 7) + ((lane >> 3) & 1) * 8) * WS + (lane >> 4) * 16;
  const int ksteps = cinp / 16;

#pragma unroll
  for (int u = 0; u < 3; ++u) {
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const uint32_t a_tap = (u * MT_HALO_W + v) * PS;
      const uint32_t b_tap = (u * 3 + v) * cinp * WS;
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t bf[NT][2];
        if constexpr (NT == 1) {
          ldmatrix_x2_trans(bf[0][0], bf[0][1], b_base + b_tap + ks * 16 * WS);
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np)
            ldmatrix_x4_trans(bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0],
                              bf[2 * np + 1][1], b_base + b_tap + ks * 16 * WS + np * 32);
        }
#pragma unroll
        for (int mt = 0; mt < MT_M_TILES; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, a_base[mt] + a_tap + ks * 32);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    }
  }

  // epilogue: bf16 tile [pixel = row*MT_TW + col][NP] in shared memory, then
  // coalesced stores; lane holds (pixel g, channels 2q, 2q+1) and pixel g+8
  __syncthreads();  // every warp is done with the halo and the weight
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT_M_TILES; ++mt) {
    const int p = (2 * warp + mt / 2) * MT_TW + (mt % 2) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int off = (nt * 8 + 2 * q) * 2;
      *reinterpret_cast<__nv_bfloat162*>(smem + p * WS + off) =
          __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(smem + (p + 8) * WS + off) =
          __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();

  const int nvalid = min(NP, cout - co0);
  __nv_bfloat16* yb = y + (int64_t)b * H * W * cout + co0;
  if (vec_y) {
    const int cc = nvalid / 8;
    for (int i = tid; i < MT_TH * MT_TW * cc; i += MT_THREADS) {
      const int p = i / cc, j = i - p * cc;
      const int gh = h0 + p / MT_TW, gw = w0 + p % MT_TW;
      if (gh < H && gw < W)
        *reinterpret_cast<uint4*>(yb + ((int64_t)gh * W + gw) * cout + j * 8) =
            *reinterpret_cast<const uint4*>(smem + p * WS + j * 16);
    }
  } else {
    for (int i = tid; i < MT_TH * MT_TW * nvalid; i += MT_THREADS) {
      const int p = i / nvalid, c = i - p * nvalid;
      const int gh = h0 + p / MT_TW, gw = w0 + p % MT_TW;
      if (gh < H && gw < W)
        yb[((int64_t)gh * W + gw) * cout + c] =
            *reinterpret_cast<const __nv_bfloat16*>(smem + p * WS + c * 2);
    }
  }
}

template <int NT>
int launch_mma(const void* x, const void* w, void* y, int B, int H, int W, int cin, int cout,
               cudaStream_t stream) {
  const cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (cout + 8 * NT - 1) / (8 * NT);
  const dim3 grid((W + MT_TW - 1) / MT_TW, (H + MT_TH - 1) / MT_TH, B * n_chunks);
  const int vec_x = cin % 8 == 0 && aligned16(x);
  const int vec_w = cout % 8 == 0 && aligned16(w);
  const int vec_y = cout % 8 == 0 && aligned16(y);
  conv3x3_mma_kernel<NT><<<grid, MT_THREADS, mma_smem_bytes(cin, NT), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), H, W, cin, cout, n_chunks, vec_x, vec_w, vec_y);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int TH = 16;                   // output rows per block
constexpr int TW = 32;                   // output columns per block (one per lane)
constexpr int PX = 4;                    // output rows per thread
constexpr int CO = 16;                   // output channels per block
constexpr int THREADS = (TH / PX) * TW;  // 128
constexpr int HALO_W = TW + 2;
constexpr int HALO_PX = (TH + 2) * HALO_W;

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
    w_s[i] = co < cout ? static_cast<float>(w[(int64_t)k * cout + co]) : 0.f;
  }
  // halo tile, zero outside the image (SAME padding and the ragged edge)
  const T* xb = x + (int64_t)b * H * W * cin;
  for (int i = tid; i < HALO_PX * cin; i += THREADS) {
    const int p = i / cin, ci = i % cin;
    const int gh = h0 - 1 + p / HALO_W, gw = w0 - 1 + p % HALO_W;
    T v = static_cast<T>(0.f);
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
        for (int r = 0; r < PX; ++r) xv[r] = static_cast<float>(xp[r * HALO_W * S + ci]);
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
      if (co0 + j < cout) yp[j] = static_cast<T>(acc[r][j]);
  }
}

// Once per device: allow every kernel here the largest dynamic shared memory.
cudaError_t opt_in_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const void* kernels[] = {
      reinterpret_cast<const void*>(conv3x3_mma_kernel<1>),
      reinterpret_cast<const void*>(conv3x3_mma_kernel<2>),
      reinterpret_cast<const void*>(conv3x3_mma_kernel<4>),
      reinterpret_cast<const void*>(conv3x3_mma_kernel<8>),
      reinterpret_cast<const void*>(conv3x3_kernel<float>),
  };
  for (const void* kernel : kernels) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
    if (err != cudaSuccess) return err;
  }
  if (dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

// Resident blocks per SM of `kernel` at `smem` bytes, or -(cudaError_t).
int blocks_per_sm(const void* kernel, int threads, size_t smem) {
  int blocks = 0;
  cudaError_t err = opt_in_smem();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

int launch_f32(const void* x, const void* w, void* y, int B, int H, int W, int cin, int cout,
               cudaStream_t stream) {
  const cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return (int)err;
  const int n_co = (cout + CO - 1) / CO;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_co);
  conv3x3_kernel<float><<<grid, THREADS, smem_bytes<float>(cin), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), H, W,
      cin, cout, n_co);
  return (int)cudaGetLastError();
}

// The launch on `device`, the caller's current device restored after it.
template <typename Run>
int on_device(int device, Run run) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int status = run();
  if (prev != device) err = cudaSetDevice(prev);
  return status ? status : (int)err;
}

}  // namespace

// Plain C interface for ctypes.  x, w, y and `stream` lie on `device`.  A
// launch returns its cudaError_t (0 = success).
extern "C" int conv3x3_nhwc_bf16(const void* x, const void* w, void* y, int B, int H, int W,
                                 int cin, int cout, int device, void* stream) {
  return on_device(device, [&] {
    return with_n_tiles(cout, [&](auto nt) {
      return launch_mma<decltype(nt)::value>(x, w, y, B, H, W, cin, cout,
                                             static_cast<cudaStream_t>(stream));
    });
  });
}

extern "C" int conv3x3_nhwc_f32(const void* x, const void* w, void* y, int B, int H, int W,
                                int cin, int cout, int device, void* stream) {
  return on_device(device, [&] {
    return launch_f32(x, w, y, B, H, W, cin, cout, static_cast<cudaStream_t>(stream));
  });
}

// Dynamic shared memory of one block, bytes (what kernels/conv3x3.py mirrors).
extern "C" long long conv3x3_smem_bytes(int cin, int cout, int bf16) {
  return bf16 ? (long long)mma_smem_bytes(cin, mma_n_tiles(cout))
              : (long long)smem_bytes<float>(cin);
}

// Resident blocks per SM for that shape, or -(cudaError_t) on failure.
extern "C" int conv3x3_blocks_per_sm(int cin, int cout, int bf16) {
  if (!bf16)
    return blocks_per_sm(reinterpret_cast<const void*>(conv3x3_kernel<float>), THREADS,
                         smem_bytes<float>(cin));
  return with_n_tiles(cout, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return blocks_per_sm(reinterpret_cast<const void*>(conv3x3_mma_kernel<NT>), MT_THREADS,
                         mma_smem_bytes(cin, NT));
  });
}

extern "C" const char* conv3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
