// int8 3x3 stride-1 SAME convolution on NHWC tensors, summed exactly in int32
// on Hopper's tensor cores (wgmma s8), with the int8 serving path's epilogue
// fused in.
//
// Replaces XLA ops of the JAX package, not a Pallas kernel: the int8 conv
// ops/wide.py:conv_wide_int8 (:255-307) and its split-input form
// conv_wide_split_int8 (:309-326), and the epilogues of
// models/quantize.py:_qconv (:65-82) and of _forward_yolo's cbs (:374-392).
// Per output element
//
//   acc = sum_{u,v,ci} xc[b,h+u-1,w+v-1,ci] * W[co,u,v,ci]      (int32, exact)
//   z   = fp32(acc) * mul[co] + badd[co]                         (two roundings)
//   ReLU (the UNets):
//   yf  = max(z, 0)
//   y   = requant: clip(round_half_even(yf), 0, 127) -> int8
//         dequant: yf -> f32 or bf16 (one rounding of the same f32)
//   SiLU (YOLOv8-seg, z at true scale):
//   yf  = z * (1 / (1 + expf(-z)))        torch's CUDA sigmoid, then a multiply
//   y   = requant: clip(round_half_even(yf * inv_s), -127, 127) -> int8
//         dequant: yf -> f32 or bf16
//
// zero padded, where xc is x, or the channel concatenation [x, x2] of a
// split input (the decoder's skip and upsample, summed in one K walk without
// a concatenated copy).  x is int8 (B, H, W, Cin); y is (B, H, W, Cout).  The
// weight is packed once, when the int8 parameters are built
// (kernels/conv3x3_int8.py:pack_weight), in the order the kernel stages it:
// per Cout piece of 256 and K chunk of 32 input channels, 9 taps x 2 halves
// of 16-byte rows, one row per output channel (K-major, as wgmma wants B),
// rows = Cout up to 256.  The epilogue multiplies and adds with __fmul_rn /
// __fadd_rn, so nvcc cannot contract them into one FMA: the result is
// bit-equal to the plain version's separate f32 multiply and add.  The SiLU
// is written as torch's CUDA sigmoid computes it for f32 (1 / (1 + exp(-z)),
// IEEE division, the accurate expf: no --use_fast_math), so the plain
// version run on the card gives the same bits.  The activation is a template
// parameter: the ReLU instantiations compile as they did before it.  Only
// the TMA kernel is built with SiLU; the wrapper pads a SiLU conv's Cin < 16
// to 16 channels (YOLOv8-seg's 3x3 stride-1 convs all have Cin >= 32).
//
// Bound.  The int8 conv moves half the bytes of the bf16 one and the tensor
// cores run int8 at twice the bf16 rate (1,979 TOPS dense on the H100): at
// unet_s's shapes the levels with Cin >= 64 at <= 64^2 are bound by
// operations, the rest by bytes (x read once, y written once).
//
// What held the first kernel (mma.sync, 8x32 tiles) back, and the design:
//   - Cout was cut into 64-channel chunks across the grid, each restaging the
//     halo.  Here one block covers all of Cout up to 256 with
//     wgmma.mma_async.m64nNk32 s8 x s8 -> s32, N = Cout rounded up to 16, 32,
//     64, 128 or 256; Cout > 256 takes pieces of 256 across the grid.
//   - Few warps per SM, two __syncthreads per K chunk.  Here a producer warp
//     issues TMA loads into a ring of 2-4 stages tracked by mbarriers for the
//     consumer warpgroups that run wgmma: two per block at N >= 32
//     (setmaxnreg moves registers to them), one per block and three blocks
//     per SM at N = 16, so that one block's epilogue runs beside another's
//     products.
//   - Fixed cost per block at the bytes-bound shallow levels.  The grid is
//     persistent, its blocks walking (b, row block, column block) tiles: tile
//     t+1's loads run while tile t's epilogue stores, mul / badd are staged
//     once per block, and where one K chunk holds all of Cin the weight stays
//     in each stage after its first load.
//   - Single-byte stores.  The epilogue goes through shared memory, 64
//     channels of 64 pixels at a time, and leaves in 16-byte stores where
//     Cout * itemsize allows (each pixel's channels are contiguous).
//   - Cin = 1 padded to 16 by a separate pass.  Cin < 16 takes a second
//     kernel that reads x as it is: the tile's halo rows into shared memory,
//     then the 9 taps folded into K (an im2col tile, K = 9 * Cin rounded up to
//     32, one k32 step for Cin <= 3).
//
// Operands in shared memory, no swizzle, K-major "core matrices" (8 rows of
// 16 bytes, 128 contiguous bytes):
//   - A, the halo, is staged per 32-channel K chunk as two planes of 16
//     channels, [TH + 2][HALO_W][16 B] each.  A tile row is 64 output pixels,
//     one m64 wgmma tile, and tap (u, v) is only a start-address offset of
//     ((r + u) * HALO_W + v) * 16 bytes: the 8-row core matrices of 8
//     consecutive halo pixels lie 128 bytes apart (SBO), the second 16
//     channels one plane further (LBO).  A from shared memory rather than
//     registers, since wgmma then reads each halo byte for all of N and the
//     consumers hold only the accumulators.  A plane is one TMA box: over the
//     5-D view (16, Cin / 16, W, H, B) of x, or, for a 16-channel input, the
//     3-D view (2 W, H, B) of 8-byte elements, whose halo rows are contiguous
//     (one request a row instead of one per pixel).  Boxes outside the image
//     zero-fill.  A lone 16-channel input loads one plane: its k32 steps
//     pair two taps, the second K half being the next halo pixel (LBO 16
//     bytes) against the next tap's weight, 6 products a row instead of 9.
//   - B, the weight chunk, [tap][half][rows][16 B], one bulk TMA copy of the
//     packed chunk; wgmma reads N >= rows rows, those past Cout land in
//     accumulator columns that are not stored.
// The tile is TH rows x 64 columns: each consumer warpgroup holds TH /
// consumers accumulators of 64 x N int32, at most 128 registers a thread.
// Ragged H and W compute on zero-filled halo and are not stored.  TMA needs
// 16-byte multiples for all but the innermost stride, so x and x2 have Cin a
// multiple of 16 and a 16-byte aligned base on this path (the wrapper pads
// other Cin >= 16 with zero channels).
//
// The host side encodes the tensor maps per call with cuTensorMapEncodeTiled
// (its entry point taken with cudaGetDriverEntryPoint: no -lcuda),
// opts each kernel into the largest dynamic shared memory once per device,
// and returns an error code after each launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

// The launch policy below (the constants and the constexpr helpers up to
// im2col_threads, and geometry) has a pure-Python twin in
// kernels/conv3x3_int8.py:launch_geometry, named beside each (py: ...); a
// change here is made there too (tests/test_torch_gpu.py holds the two
// against each other on the card).
constexpr int SMEM_OPT_IN = 232448;  // the most a block may use on sm_90 (py: SMEM_MAX)
constexpr int MAX_DEVICES = 64;

constexpr int TW = 64;                   // columns per tile: one m64 tile a row (py: _TW)
constexpr int HALO_W = TW + 2;
constexpr int KC = 32;                   // K chunk: one k32 step a tap (py: CIN_CHUNK)
constexpr int N_MAX = 256;               // output channels per block (py: _N_MAX)
constexpr int SM_SMEM = 233472;          // an SM's; 1 KiB more a block (py: _SM_SMEM)
constexpr int MAX_STAGES = 4;            // py: _MAX_STAGES
constexpr int ALIGN = 128;               // TMA destinations (py: _ALIGN)
constexpr int PIECE_MAX = 64;            // channels per epilogue pass (py: _PIECE_MAX)
constexpr int ERR_ENCODE = 10000;        // + CUresult: cuTensorMapEncodeTiled failed

enum OutKind { OUT_INT8 = 0, OUT_F32 = 1, OUT_BF16 = 2 };
enum Act { ACT_RELU = 0, ACT_SILU = 1 };

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int cin_padded(int cin) { return round_up(cin, KC); }
// N of the wgmma for a Cout: 16, 32, 64, 128 or 256 (py: _n_for)
__host__ __device__ constexpr int n_for(int cout) {
  return cout <= 16 ? 16 : cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 128 ? 128 : 256;
}
// m64 tiles (tile rows) per consumer warpgroup: 128 accumulator registers at most
// (py: the dict in launch_geometry's `rows`)
__host__ __device__ constexpr int m_tiles(int np) {
  return np >= 256 ? 1 : np == 128 ? 2 : np == 64 ? 4 : 8;
}
// consumer warpgroups per block, and blocks per SM: at N = 16 (the shallow,
// bytes-bound levels) one consumer a block and three blocks an SM (with two
// stages each), so that one block's epilogue runs beside another's wgmma
// (PERF.md §6); else two consumers (at N = 32 one consumer's 128
// accumulator registers spill under two blocks an SM) (py: _consumers;
// tma_blocks: launch_geometry's `per_sm`)
__host__ __device__ constexpr int consumers(int np) { return np <= 16 ? 1 : 2; }
__host__ __device__ constexpr int tma_blocks(int np) { return np <= 16 ? 3 : 1; }
__host__ __device__ constexpr int tma_threads(int np) {
  return 128 * consumers(np) + (consumers(np) == 1 ? 32 : 128);  // + the producer
}
// py: launch_geometry's `budget`
__host__ __device__ constexpr int smem_budget(int blocks) {
  return SM_SMEM / blocks - 1024 < SMEM_OPT_IN ? SM_SMEM / blocks - 1024 : SMEM_OPT_IN;
}
// py: launch_geometry's `rows`; a_plane_bytes its `plane`, stage_bytes its `stage`
__host__ __device__ constexpr int tile_rows(int np) { return consumers(np) * m_tiles(np); }
__host__ __device__ constexpr int piece(int np) { return np < PIECE_MAX ? np : PIECE_MAX; }
__host__ __device__ constexpr int a_box_bytes(int np) {
  return (tile_rows(np) + 2) * HALO_W * 16;
}
__host__ __device__ constexpr int a_plane_bytes(int np) {
  return round_up(a_box_bytes(np), ALIGN);
}
__host__ __device__ constexpr int b_bytes(int np) { return 18 * np * 16; }
__host__ __device__ constexpr int stage_bytes(int np) {
  return 2 * a_plane_bytes(np) + b_bytes(np);
}
// epilogue staging, per consumer: 64 pixels x a piece of channels (up to 4 B
// each), rows 16 bytes apart beyond that (py: `staging` in _fixed_bytes)
__host__ __device__ constexpr int staging_bytes(int np) {
  return consumers(np) * TW * (piece(np) * 4 + 16);
}
// staging, mul and badd, 2 mbarriers per stage, and room to align the base
// (py: _fixed_bytes)
__host__ __device__ constexpr int fixed_bytes(int np) {
  return staging_bytes(np) + 8 * np + 16 * MAX_STAGES + ALIGN;
}
// py: launch_geometry's `stages`; tma_smem_bytes its `smem` on the TMA route
__host__ __device__ constexpr int stages_for(int np) {
  return (smem_budget(tma_blocks(np)) - fixed_bytes(np)) / stage_bytes(np) < MAX_STAGES
             ? (smem_budget(tma_blocks(np)) - fixed_bytes(np)) / stage_bytes(np)
             : MAX_STAGES;
}
__host__ __device__ constexpr int tma_smem_bytes(int np) {
  return stages_for(np) * stage_bytes(np) + fixed_bytes(np);
}
// the im2col kernel: K steps of 32 for Cin < 16 (py: launch_geometry's `steps`,
// `halo` and `smem` on the im2col route)
__host__ __device__ constexpr int im2col_steps(int cin) { return (9 * cin + KC - 1) / KC; }
__host__ __device__ constexpr int im2col_a_bytes(int np) { return tile_rows(np) * TW * KC; }
__host__ __device__ constexpr int im2col_halo_bytes(int np, int cin) {
  return round_up((tile_rows(np) + 2) * HALO_W * cin, 16);
}
__host__ __device__ constexpr int im2col_smem_bytes(int np, int cin) {
  return im2col_a_bytes(np) + im2col_steps(cin) * KC * np + 4 * im2col_steps(cin) * KC +
         im2col_halo_bytes(np, cin) + fixed_bytes(np);
}
// blocks per SM the im2col kernel is built for (its __launch_bounds__; py:
// `per_sm` on the im2col route)
__host__ __device__ constexpr int im2col_blocks(int np) { return np <= 16 ? 4 : 1; }
__host__ __device__ constexpr int im2col_threads(int np) { return 128 * consumers(np); }

static_assert(stages_for(16) >= 2 && stages_for(32) >= 2 && stages_for(64) >= 2 &&
                  stages_for(128) >= 2 && stages_for(256) >= 2,
              "ring too shallow");
static_assert(tma_smem_bytes(16) <= smem_budget(tma_blocks(16)) &&
                  tma_smem_bytes(32) <= SMEM_OPT_IN &&
                  tma_smem_bytes(64) <= SMEM_OPT_IN && tma_smem_bytes(128) <= SMEM_OPT_IN &&
                  tma_smem_bytes(256) <= SMEM_OPT_IN,
              "a TMA instantiation exceeds shared memory");
static_assert(im2col_smem_bytes(16, 15) <= smem_budget(im2col_blocks(16)) &&
                  im2col_smem_bytes(256, 15) <= SMEM_OPT_IN,
              "im2col exceeds shared memory");

struct Params {
  const int8_t* x;        // im2col path: x itself
  const int8_t* w;        // packed (pieces, chunks, 9, 2, rows, 16)
  const float* mul;
  const float* badd;
  const float* inv_s;     // SiLU requant: the output's 1 / scale (one f32), else null
  void* y;
  int H, W, cin, cout;
  int rows;               // weight rows per Cout piece in the pack
  int w_chunks;           // K chunks of the pack
  int p1, p_all;          // 16-channel pieces of x, of [x, x2] (the TMA path)
  int has_x2;
  int x_rows, x2_rows;    // the source has 16 channels: its halo rows are contiguous
  int n_chunks;           // K chunks of 32 channels (TMA) or im2col steps
  int tiles_h, tiles_w, n_pieces, n_tiles;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A contiguous run of `bytes` (a multiple of 16) from global memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, no swizzle: start, LBO (between the two
// 16-byte core matrices of a k32 step) and SBO (between 8-row groups), in
// 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After a wait: the accumulators are read only from here on (the compiler
// sees no dependence of those reads on the wait itself).
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A (64 x 32, descriptor a) * B (32 x N, descriptor b); d = A * B when
// scale_d is 0.  Fragment: thread t of the warpgroup holds rows 16 * (t / 32)
// + (t % 32) / 4 + 8 i and columns 8 k + 2 (t % 4) + j in d[4 k + 2 i + j].
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// -- the epilogue --------------------------------------------------------------

template <int OUT>
struct OutType;
template <>
struct OutType<OUT_INT8> { using T = int8_t; };
template <>
struct OutType<OUT_F32> { using T = float; };
template <>
struct OutType<OUT_BF16> { using T = __nv_bfloat16; };

// The activation of one sum at true or requant scale (see the top).
template <int ACT>
__device__ __forceinline__ float activate(int acc, float m, float b) {
  const float z = __fadd_rn(__fmul_rn(__int2float_rn(acc), m), b);
  if constexpr (ACT == ACT_RELU) {
    return fmaxf(z, 0.f);
  } else {
    return __fmul_rn(z, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z))));
  }
}

// Two neighbouring channels of one pixel into the staging row; inv_s is read
// by the SiLU requant only.
template <int OUT, int ACT>
__device__ __forceinline__ void stage_pair(unsigned char* dst, float y0, float y1,
                                           float inv_s) {
  if constexpr (OUT == OUT_INT8 && ACT == ACT_RELU) {
    const int r0 = min(max(__float2int_rn(y0), 0), 127);
    const int r1 = min(max(__float2int_rn(y1), 0), 127);
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(r0 | (r1 << 8));
  } else if constexpr (OUT == OUT_INT8) {
    const int r0 = min(max(__float2int_rn(__fmul_rn(y0, inv_s)), -127), 127);
    const int r1 = min(max(__float2int_rn(__fmul_rn(y1, inv_s)), -127), 127);
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>((r0 & 0xff) | ((r1 & 0xff) << 8));
  } else if constexpr (OUT == OUT_F32) {
    *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
  } else {
    __nv_bfloat162 v;
    v.x = __float2bfloat16_rn(y0);
    v.y = __float2bfloat16_rn(y1);
    *reinterpret_cast<__nv_bfloat162*>(dst) = v;
  }
}

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// One consumer warpgroup's accumulators (tile rows row0 .. row0 + MT - 1 of
// the tile at (b, h0, w0), channels n0 ..) through the epilogue into y: per
// row and 64-channel piece, into the staging buffer, then out in 16-byte
// stores where Cout * itemsize and the piece allow, else element by element.
template <int NP, int OUT, int ACT>
__device__ __forceinline__ void store_tile(int (&acc)[m_tiles(NP)][NP / 2], unsigned char* stg,
                                           const float* mul_s, const float* badd_s, float inv_s,
                                           const Params& p, int b, int h0, int w0, int n0,
                                           int row0, int bar_id) {
  using T = typename OutType<OUT>::T;
  constexpr int MT = m_tiles(NP), PC = piece(NP), ES = sizeof(T);
  constexpr int PITCH = PC * ES + 16;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
  const int cout = p.cout;
  const bool vec = (cout * ES) % 16 == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int gh = h0 + row0 + mt;
#pragma unroll
    for (int pc = 0; pc < NP / PC; ++pc) {
#pragma unroll
      for (int kk = 0; kk < PC / 8; ++kk) {
        const int k = pc * (PC / 8) + kk;
        const int n = 8 * k + 2 * q;
        const float m0 = mul_s[n], m1 = mul_s[n + 1], b0 = badd_s[n], b1 = badd_s[n + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int px = 16 * warp + g + 8 * i;
          stage_pair<OUT, ACT>(stg + px * PITCH + (8 * kk + 2 * q) * ES,
                               activate<ACT>(acc[mt][4 * k + 2 * i], m0, b0),
                               activate<ACT>(acc[mt][4 * k + 2 * i + 1], m1, b1), inv_s);
        }
      }
      wg_barrier(bar_id);
      const int c0 = n0 + pc * PC;
      const int cw = min(PC, cout - c0);
      const int npx = min(TW, p.W - w0);
      if (gh < p.H && cw > 0) {
        unsigned char* row = static_cast<unsigned char*>(p.y) +
                             ((((int64_t)b * p.H + gh) * p.W + w0) * cout + c0) * ES;
        if (vec && (c0 * ES) % 16 == 0 && (cw * ES) % 16 == 0) {
          const int per = cw * ES / 16;
          for (int i = t; i < npx * per; i += 128) {
            const int px = i / per, c = i % per;
            *reinterpret_cast<uint4*>(row + (int64_t)px * cout * ES + c * 16) =
                *reinterpret_cast<const uint4*>(stg + px * PITCH + c * 16);
          }
        } else {
          for (int i = t; i < npx * cw; i += 128) {
            const int px = i / cw, c = i % cw;
            *reinterpret_cast<T*>(row + ((int64_t)px * cout + c) * ES) =
                *reinterpret_cast<const T*>(stg + px * PITCH + c * ES);
          }
        }
      }
      wg_barrier(bar_id);
    }
  }
}

struct Tile {
  int b, h0, w0, n0;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int t, int th) {
  Tile r;
  r.n0 = (t % p.n_pieces) * N_MAX;
  t /= p.n_pieces;
  r.w0 = (t % p.tiles_w) * TW;
  t /= p.tiles_w;
  r.h0 = (t % p.tiles_h) * th;
  r.b = t / p.tiles_h;
  return r;
}

// mul / badd of the block's channels (every tile of a block has one n0: the
// grid is a multiple of n_pieces) into shared memory, zeros past Cout.
__device__ __forceinline__ void stage_scales(const Params& p, int n0, int np, float* mul_s,
                                             float* badd_s, int tid, int nthreads) {
  for (int i = tid; i < np; i += nthreads) {
    const bool ok = n0 + i < p.cout;
    mul_s[i] = ok ? p.mul[n0 + i] : 0.f;
    badd_s[i] = ok ? p.badd[n0 + i] : 0.f;
  }
}

// -- the TMA kernel: Cin (and Cin2) multiples of 16 ------------------------------

template <int NP, int OUT, int ACT>
__global__ void __launch_bounds__(tma_threads(NP), tma_blocks(NP))
conv3x3_int8_tma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_x2, const Params p) {
  constexpr int MT = m_tiles(NP), TH = tile_rows(NP), STAGES = stages_for(NP);
  constexpr int CONS = consumers(NP);
  constexpr int A_PLANE = a_plane_bytes(NP), STAGE = stage_bytes(NP);
  constexpr uint32_t A_BOX = a_box_bytes(NP);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN);
  unsigned char* stg = smem + STAGES * STAGE;
  float* mul_s = reinterpret_cast<float*>(stg + staging_bytes(NP));
  float* badd_s = mul_s + NP;
  const uint32_t bars = smem_addr(badd_s + NP);  // full[s] at 8 s, empty[s] at 8 (STAGES + s)
  const uint32_t ring = smem_addr(smem);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), CONS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One K chunk (Cin + Cin2 <= 32): the weight stays in each stage after its
  // first use.  A lone 16-channel input: its second plane is neither loaded
  // nor read (the products pair taps instead).
  const bool one_chunk = p.n_chunks == 1, pair = one_chunk && p.p_all == 1;
  const uint32_t b_bytes_used = 18 * 16 * p.rows;
  if (wg == CONS) {
    // producer: one thread issues every load
    if constexpr (CONS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONS * 128) {
      const int8_t* w_piece = p.w + (int64_t)(blockIdx.x % p.n_pieces) * p.w_chunks *
                                        b_bytes_used;
      int stage = 0, uses = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
        const Tile tl = tile_at(p, t, TH);
        for (int c = 0; c < p.n_chunks; ++c, ++uses) {
          mbar_wait(bars + 8 * (STAGES + stage), phase ^ 1);
          const uint32_t full = bars + 8 * stage;
          const uint32_t a = ring + stage * STAGE;
          const bool load_b = !one_chunk || uses < STAGES;
          const bool load_a1 = !pair;
          mbar_expect_tx(full, A_BOX * (load_a1 ? 2 : 1) + (load_b ? b_bytes_used : 0));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // 16-channel piece k of [x, x2]; past both, zeros (out of bounds
            // of the last source's 5-D map)
            const int k = 2 * c + j;
            if (j == 1 && !load_a1) break;
            const bool second = p.has_x2 && k >= p.p1;
            const CUtensorMap* map = second ? &map_x2 : &map_x;
            if (second ? p.x2_rows : p.x_rows)
              tma_load_3d(a + j * A_PLANE, map, full, 2 * (tl.w0 - 1), tl.h0 - 1, tl.b);
            else
              tma_load_5d(a + j * A_PLANE, map, full, 0, second ? k - p.p1 : k, tl.w0 - 1,
                          tl.h0 - 1, tl.b);
          }
          if (load_b) bulk_load(a + 2 * A_PLANE, w_piece + (int64_t)c * b_bytes_used,
                                b_bytes_used, full);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    if constexpr (CONS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ctid = threadIdx.x;  // 0 .. 128 * CONS - 1
    const int n0 = (blockIdx.x % p.n_pieces) * N_MAX;
    stage_scales(p, n0, NP, mul_s, badd_s, ctid, CONS * 128);
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONS * 128) : "memory");
    unsigned char* my_stg = stg + wg * TW * (piece(NP) * 4 + 16);
    float inv_s = 0.f;
    if constexpr (OUT == OUT_INT8 && ACT == ACT_SILU) inv_s = *p.inv_s;
    int acc[MT][NP / 2] = {};
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      const Tile tl = tile_at(p, t, TH);
      for (int c = 0; c < p.n_chunks; ++c) {
        mbar_wait(bars + 8 * stage, phase);
        const uint32_t a = ring + stage * STAGE;
        const uint32_t bw = a + 2 * A_PLANE;
        wgmma_fence();
        if (pair) {
          // a lone 16-channel input: a k32 step takes two taps, its second K
          // half the next halo pixel (LBO 16 bytes) against the next tap's
          // weight (LBO one tap); tap (u, 2)'s second half meets the pack's
          // zero channels
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int r = wg * MT + mt;
#pragma unroll
            for (int u = 0; u < 3; ++u) {
              const uint32_t row = a + (r + u) * HALO_W * 16, w_u = bw + 6 * u * p.rows * 16;
              wgmma_s8<NP>(acc[mt], make_desc(row, 16, 128),
                           make_desc(w_u, 2 * p.rows * 16, 128), u != 0);
              wgmma_s8<NP>(acc[mt], make_desc(row + 2 * 16, 16, 128),
                           make_desc(w_u + 4 * p.rows * 16, p.rows * 16, 128), 1);
            }
          }
        } else {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int r = wg * MT + mt;
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
              const int u = tap / 3, v = tap % 3;
              const uint64_t da = make_desc(a + ((r + u) * HALO_W + v) * 16, A_PLANE, 128);
              const uint64_t db = make_desc(bw + 2 * tap * p.rows * 16, p.rows * 16, 128);
              wgmma_s8<NP>(acc[mt], da, db, (c | tap) != 0);
            }
          }
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          mbar_arrive(bars + 8 * (STAGES + prev));
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      mbar_arrive(bars + 8 * (STAGES + prev));
      store_tile<NP, OUT, ACT>(acc, my_stg, mul_s, badd_s, inv_s, p, tl.b, tl.h0, tl.w0, tl.n0,
                               wg * MT, 2 + wg);
    }
  }
}

// -- the im2col kernel: 1 <= Cin < 16, read as it is -------------------------------

template <int NP, int OUT>
__global__ void __launch_bounds__(im2col_threads(NP), im2col_blocks(NP))
conv3x3_int8_im2col_kernel(const Params p) {
  constexpr int MT = m_tiles(NP), TH = tile_rows(NP), THREADS = im2col_threads(NP);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN);
  const int steps = p.n_chunks, cin = p.cin;
  unsigned char* a_s = smem;                                  // [TH][2][64][16]
  unsigned char* b_s = a_s + im2col_a_bytes(NP);              // [2 steps][NP][16]
  int* off_s = reinterpret_cast<int*>(b_s + steps * KC * NP);  // k -> halo byte offset, -1
  unsigned char* halo_s = reinterpret_cast<unsigned char*>(off_s + steps * KC);
  unsigned char* stg = halo_s + im2col_halo_bytes(NP, cin);
  float* mul_s = reinterpret_cast<float*>(stg + staging_bytes(NP));
  float* badd_s = mul_s + NP;
  const int tid = threadIdx.x, wg = tid / 128;
  const int piece_i = blockIdx.x % p.n_pieces, n0 = piece_i * N_MAX;

  stage_scales(p, n0, NP, mul_s, badd_s, tid, THREADS);
  // K = tap * Cin + ci: its byte in the staged halo, relative to the pixel
  for (int k = tid; k < steps * KC; k += THREADS) {
    const int tap = k / cin;
    off_s[k] = k < 9 * cin ? ((tap / 3) * HALO_W + tap % 3) * cin + k % cin : -1;
  }
  // the weight of this Cout piece in K order, 16-byte planes [plane][NP rows][16]
  const int8_t* wpc = p.w + (int64_t)piece_i * p.w_chunks * 18 * 16 * p.rows;
  for (int i = tid; i < steps * KC * NP; i += THREADS) {
    const int e = i % 16, n = (i / 16) % NP, k = 16 * (i / (16 * NP)) + e;
    int8_t v = 0;
    if (n < p.rows && k < 9 * cin)  // chunk 0, half 0: tap (k / cin), channel (k % cin)
      v = wpc[((k / cin) * 2 * p.rows + n) * 16 + k % cin];
    b_s[i] = static_cast<unsigned char>(v);
  }
  __syncthreads();

  unsigned char* my_stg = stg + wg * TW * (piece(NP) * 4 + 16);
  int acc[MT][NP / 2] = {};
  const uint32_t a_u = smem_addr(a_s), b_u = smem_addr(b_s);
  const int halo_n = (TH + 2) * HALO_W * cin;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const Tile tl = tile_at(p, t, TH);
    // the (TH + 2) x HALO_W halo's bytes, zeros outside the image: each row
    // of it is a contiguous run of x
    const int8_t* xb = p.x + (int64_t)tl.b * p.H * p.W * cin;
    for (int i = tid; i < halo_n; i += THREADS) {
      const int r = i / (HALO_W * cin), rem = i % (HALO_W * cin);
      const int gh = tl.h0 + r - 1, gw = tl.w0 - 1 + rem / cin;
      halo_s[i] = gh >= 0 && gh < p.H && gw >= 0 && gw < p.W
                      ? static_cast<unsigned char>(xb[((int64_t)gh * p.W + gw) * cin + rem % cin])
                      : 0;
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      // A: the 32 K values of step s for pixel px of tile row r, two planes
      for (int i = tid; i < TH * TW; i += THREADS) {
        const int r = i / TW, px = i % TW;
        const unsigned char* src = halo_s + (r * HALO_W + px) * cin;
        uint32_t word[8];
#pragma unroll
        for (int wi = 0; wi < 8; ++wi) {
          uint32_t v = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = off_s[s * KC + 4 * wi + e];
            v |= (o >= 0 ? (uint32_t)src[o] : 0u) << (8 * e);
          }
          word[wi] = v;
        }
        unsigned char* dst = a_s + r * 2 * TW * 16 + px * 16;
        *reinterpret_cast<uint4*>(dst) = make_uint4(word[0], word[1], word[2], word[3]);
        *reinterpret_cast<uint4*>(dst + TW * 16) = make_uint4(word[4], word[5], word[6], word[7]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wg * MT + mt;
        const uint64_t da = make_desc(a_u + r * 2 * TW * 16, TW * 16, 128);
        const uint64_t db = make_desc(b_u + 2 * s * NP * 16, NP * 16, 128);
        wgmma_s8<NP>(acc[mt], da, db, s != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      __syncthreads();  // A and the halo are read before they are rebuilt
    }
    store_tile<NP, OUT, ACT_RELU>(acc, my_stg, mul_s, badd_s, 0.f, p, tl.b, tl.h0, tl.w0,
                                  tl.n0, wg * MT, 2 + wg);
  }
}

// -- host ------------------------------------------------------------------------

template <int NP, int OUT, int ACT>
const void* tma_ptr() {
  return reinterpret_cast<const void*>(conv3x3_int8_tma_kernel<NP, OUT, ACT>);
}

template <int NP, int OUT>
const void* im2col_ptr() {
  return reinterpret_cast<const void*>(conv3x3_int8_im2col_kernel<NP, OUT>);
}

// f(std::integral_constant<int, NP>) for the N that serves cout.
template <typename F>
auto with_n(int cout, F f) {
  switch (n_for(cout)) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return f(std::integral_constant<int, 256>{});
  }
}

// the 9 kernels of one N: TMA with ReLU and with SiLU, im2col (ReLU), each
// out kind
constexpr int KERNELS_PER_N = 9;

template <int NP>
void add_kernels(const void** out) {
  out[0] = tma_ptr<NP, OUT_INT8, ACT_RELU>();
  out[1] = tma_ptr<NP, OUT_F32, ACT_RELU>();
  out[2] = tma_ptr<NP, OUT_BF16, ACT_RELU>();
  out[3] = im2col_ptr<NP, OUT_INT8>();
  out[4] = im2col_ptr<NP, OUT_F32>();
  out[5] = im2col_ptr<NP, OUT_BF16>();
  out[6] = tma_ptr<NP, OUT_INT8, ACT_SILU>();
  out[7] = tma_ptr<NP, OUT_F32, ACT_SILU>();
  out[8] = tma_ptr<NP, OUT_BF16, ACT_SILU>();
}

struct DeviceState {
  std::atomic<bool> ready{false};
  int sms = 0;
};

// Once per device: allow every kernel the largest dynamic shared memory, and
// read the SM count.  -> the device's SM count, or 0 and *err.
int prepare_device(cudaError_t* err) {
  static DeviceState state[MAX_DEVICES];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  DeviceState* st = dev < MAX_DEVICES ? &state[dev] : nullptr;
  if (st && st->ready.load(std::memory_order_acquire)) return st->sms;
  const void* kernels[5 * KERNELS_PER_N];
  add_kernels<16>(kernels);
  add_kernels<32>(kernels + KERNELS_PER_N);
  add_kernels<64>(kernels + 2 * KERNELS_PER_N);
  add_kernels<128>(kernels + 3 * KERNELS_PER_N);
  add_kernels<256>(kernels + 4 * KERNELS_PER_N);
  for (const void* kernel : kernels) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_OPT_IN);
    if (*err != cudaSuccess) return 0;
  }
  int sms = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  if (st) {
    st->sms = sms;
    st->ready.store(true, std::memory_order_release);
  }
  return sms;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load(std::memory_order_acquire);
  if (f) return f;
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
          cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  f = reinterpret_cast<EncodeTiled>(ptr);
  fn.store(f, std::memory_order_release);
  return f;
}

CUresult encode(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType type, int rank,
                const void* x, const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(x), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The halo map of an int8 (B, H, W, cin) NHWC tensor, cin % 16 == 0.  rows:
// cin == 16, each halo row a contiguous run of HALO_W * 16 bytes, as the 3-D
// (2 W, H, B) view of 8-byte elements, box 2 HALO_W x (th + 2) x 1 (one TMA
// request a row); else the 5-D (16, cin / 16, W, H, B) byte view, box 16 x 1
// x HALO_W x (th + 2) x 1 (one 16-channel piece).
int encode_halo(EncodeTiled enc, CUtensorMap* map, const void* x, int B, int H, int W, int cin,
                int th, bool rows) {
  CUresult r;
  if (rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)2 * W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)16 * W, (cuuint64_t)16 * H * W};
    const cuuint32_t box[3] = {2 * HALO_W, (cuuint32_t)(th + 2), 1};
    r = encode(enc, map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3, x, dims, strides, box);
  } else {
    const cuuint64_t dims[5] = {16, (cuuint64_t)(cin / 16), (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[4] = {16, (cuuint64_t)cin, (cuuint64_t)W * cin,
                                   (cuuint64_t)H * W * cin};
    const cuuint32_t box[5] = {16, 1, HALO_W, (cuuint32_t)(th + 2), 1};
    r = encode(enc, map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, x, dims, strides, box);
  }
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// The launch: route (0 TMA, 1 im2col), N, tile rows, Cout pieces, ring
// stages, dynamic shared memory, tiles and the persistent grid.
struct Geometry {
  int route, np, tile_rows, n_pieces, stages, smem, n_tiles, grid, blocks_per_sm;
};

// py: launch_geometry
Geometry geometry(int B, int H, int W, int cin, int cin2, int cout, int sms) {
  Geometry g;
  g.route = (cin2 == 0 && cin < 16) ? 1 : 0;
  g.np = n_for(cout);
  g.tile_rows = tile_rows(g.np);
  g.n_pieces = (cout + N_MAX - 1) / N_MAX;
  int smem = 0;
  with_n(cout, [&](auto n) {
    constexpr int NP = decltype(n)::value;
    g.stages = g.route == 0 ? stages_for(NP) : 1;
    smem = g.route == 0 ? tma_smem_bytes(NP) : im2col_smem_bytes(NP, cin);
    g.blocks_per_sm = g.route == 0 ? tma_blocks(NP) : im2col_blocks(NP);
    return 0;
  });
  g.smem = smem;
  g.n_tiles = B * ((H + g.tile_rows - 1) / g.tile_rows) * ((W + TW - 1) / TW) * g.n_pieces;
  // a multiple of n_pieces, so that each block keeps one Cout piece
  const int most = sms * g.blocks_per_sm / g.n_pieces * g.n_pieces;
  g.grid = g.n_tiles < most ? g.n_tiles : (most > 0 ? most : g.n_pieces);
  return g;
}

template <int NP, int OUT, int ACT>
int launch(const void* x, const void* x2, const void* w, const void* mul, const void* badd,
           const void* inv_s, void* y, int B, int H, int W, int cin, int cin2, int cout, int sms,
           cudaStream_t stream) {
  const Geometry g = geometry(B, H, W, cin, cin2, cout, sms);
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.mul = static_cast<const float*>(mul);
  p.badd = static_cast<const float*>(badd);
  p.inv_s = static_cast<const float*>(inv_s);
  p.y = y;
  p.H = H;
  p.W = W;
  p.cin = cin;
  p.cout = cout;
  p.rows = cout < N_MAX ? cout : N_MAX;
  p.w_chunks = cin_padded(cin + cin2) / KC;
  p.p1 = cin / 16;
  p.p_all = (cin + cin2) / 16;
  p.has_x2 = cin2 > 0;
  p.tiles_h = (H + g.tile_rows - 1) / g.tile_rows;
  p.tiles_w = (W + TW - 1) / TW;
  p.n_pieces = g.n_pieces;
  p.n_tiles = g.n_tiles;
  if (g.n_tiles == 0) return 0;
  if (g.route == 1) {
    if constexpr (ACT != ACT_RELU) return (int)cudaErrorInvalidValue;  // built with ReLU only
    p.n_chunks = im2col_steps(cin);
    conv3x3_int8_im2col_kernel<NP, OUT><<<g.grid, im2col_threads(NP), g.smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  p.n_chunks = p.w_chunks;
  // a piece past both sources (odd piece count) is read out of bounds of the
  // last source's 5-D map, unless one chunk holds it (then the paired taps
  // read no second plane)
  const bool absent = p.p_all % 2 && p.n_chunks > 1;
  p.x_rows = cin == 16 && !(absent && !cin2);
  p.x2_rows = cin2 == 16 && !absent;
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap map_x, map_x2;
  int err = encode_halo(enc, &map_x, x, B, H, W, cin, g.tile_rows, p.x_rows);
  if (!err && cin2) err = encode_halo(enc, &map_x2, x2, B, H, W, cin2, g.tile_rows, p.x2_rows);
  if (!cin2) map_x2 = map_x;
  if (err) return err;
  conv3x3_int8_tma_kernel<NP, OUT, ACT><<<g.grid, tma_threads(NP), g.smem, stream>>>(
      map_x, map_x2, p);
  return (int)cudaGetLastError();
}

// The launch after its arguments' checks (conv3x3_int8_nhwc's contract, below).
int launch_checked(const void* x, const void* x2, const void* w, const void* mul,
                   const void* badd, const void* inv_s, void* y, int B, int H, int W, int cin,
                   int cin2, int cout, int out_kind, int act, cudaStream_t s) {
  if (cin < 1 || cin2 < 0 || cout < 1 || (cin2 > 0) != (x2 != nullptr))
    return (int)cudaErrorInvalidValue;
  if (act != ACT_RELU && act != ACT_SILU) return (int)cudaErrorInvalidValue;
  if (act == ACT_SILU && (cin2 == 0 && cin < 16)) return (int)cudaErrorInvalidValue;
  if ((act == ACT_SILU && out_kind == OUT_INT8) != (inv_s != nullptr))
    return (int)cudaErrorInvalidValue;
  if (cin2 > 0 || cin >= 16) {
    if (cin % 16 != 0 || cin2 % 16 != 0) return (int)cudaErrorInvalidValue;
    if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(x2) |
          reinterpret_cast<uintptr_t>(w)) & 15) != 0)
      return (int)cudaErrorMisalignedAddress;
  }
  cudaError_t err;
  const int sms = prepare_device(&err);
  if (err != cudaSuccess) return (int)err;
  return with_n(cout, [&](auto n) {
    auto go = [&](auto out, auto a) {
      return launch<decltype(n)::value, decltype(out)::value, decltype(a)::value>(
          x, x2, w, mul, badd, inv_s, y, B, H, W, cin, cin2, cout, sms, s);
    };
    auto with_act = [&](auto out) {
      return act == ACT_SILU ? go(out, std::integral_constant<int, ACT_SILU>{})
                             : go(out, std::integral_constant<int, ACT_RELU>{});
    };
    switch (out_kind) {
      case OUT_INT8: return with_act(std::integral_constant<int, OUT_INT8>{});
      case OUT_F32: return with_act(std::integral_constant<int, OUT_F32>{});
      case OUT_BF16: return with_act(std::integral_constant<int, OUT_BF16>{});
      default: return (int)cudaErrorInvalidValue;
    }
  });
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

// Plain C interface for ctypes.  out_kind: 0 = int8 (requant), 1 = f32,
// 2 = bf16 (dequant); act: 0 = ReLU, 1 = SiLU, whose int8 requant reads
// inv_s (one f32 on the device; null otherwise).  x2 (cin2 channels, or
// null and 0) is the second part of a split input.  Cin < 16 without x2
// reads x as it is (ReLU only); otherwise x and x2 must have 16-multiples
// of channels and 16-byte aligned bases, as must the weight.  A launch
// returns its cudaError_t (0 = success), or ERR_ENCODE + the CUresult of a
// tensor map that would not encode.  All pointers and `stream` lie on `device`.
extern "C" int conv3x3_int8_nhwc(const void* x, const void* x2, const void* w, const void* mul,
                                 const void* badd, const void* inv_s, void* y, int B, int H,
                                 int W, int cin, int cin2, int cout, int out_kind, int act,
                                 int device, void* stream) {
  return on_device(device, [&] {
    return launch_checked(x, x2, w, mul, badd, inv_s, y, B, H, W, cin, cin2, cout, out_kind,
                          act, static_cast<cudaStream_t>(stream));
  });
}

// The launch geometry the kernel takes on this device, into out[9]: route,
// N, tile rows, Cout pieces, stages, shared memory bytes, tiles, grid, blocks
// per SM (kernels/conv3x3_int8.py:launch_geometry computes the same).
extern "C" int conv3x3_int8_geometry(int B, int H, int W, int cin, int cin2, int cout,
                                     int* out) {
  cudaError_t err;
  const int sms = prepare_device(&err);
  if (err != cudaSuccess) return (int)err;
  const Geometry g = geometry(B, H, W, cin, cin2, cout, sms);
  const int v[9] = {g.route, g.np, g.tile_rows, g.n_pieces, g.stages,
                    g.smem, g.n_tiles, g.grid, g.blocks_per_sm};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* conv3x3_int8_error_string(int err) {
  if (err >= ERR_ENCODE) return "cuTensorMapEncodeTiled failed (code - 10000 is the CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
