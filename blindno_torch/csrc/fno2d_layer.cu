// One FNO2d layer on Hopper (sm_90a): 3xTF32 tensor-core transforms, f32 accumulation.
//
// Replaces the TPU kernels `fno2d_layer_pallas` (blindno/ops/spectral_pallas.py:165) and
// `spectral_conv2d_pallas` (:234). Both compute, per batch element,
//   y = irDFT_W( iDFT+-_H( mix( DFT+-_H( rDFT_W(x) ) ) ) )          (spectral chain)
//   y += pk^T x + pb ; y = gelu_erf(y)                               (optional epilogue)
// with the truncated DFTs as small dense products against the matrices that the wrapper
// builds (float64 rounded to f32, cached; blindno_torch/ops/dft.py), so the result
// matches the plain PyTorch version blindno_torch/ops/fno_layer.py up to summation order
// and the rounding below.
//
// What bounds it. At the main serving shape (B=4, C=12, H=W=76, m1=m2=32, K=2*m1=64) the
// function must move x (1.11 MB), y (1.11 MB) and wr, wi (2.36 MB): 1.37 us at 3.35 TB/s.
// Its least arithmetic (transforms as FFTs, the mix, the pointwise term) is ~32 MFLOP,
// 0.5 us at the 67 TFLOP/s f32 peak: the bound is the bytes. This kernel does the
// transforms as dense products instead, 197 MFLOP, which 3xTF32 (below) turns into
// ~0.6 GFLOP of TF32 tensor-core work, ~1.2 us at the 495 TFLOP/s TF32 peak.
// chip_smoke.py computes the bound from its own shapes and prints it beside the measured
// time and the card's nvidia-smi name and power limit (PERF.md).
//
// Design: three launches on the caller's stream, each product computed once.
//   S1 fno2d_forward_transform  grid (B*Cin planes, m2/8 column tiles), 256 threads.
//      Stages its x plane, its 8 columns of the W matrices and the whole +-H matrix in
//      shared memory (cp.async), runs the rDFT along W (Y = X Fy: M=H, N=16 real columns,
//      K=W) and the +-DFT along H as one real product [Sr | Si] = [Fxre^T | Fxim^T] B2
//      with B2 = [[Yr, Yi], [-Yi, Yr]] (M=2*m1, N=16, K=2H), and writes its spectrum
//      columns, through shared memory, as whole rows of a scratch laid out (m2, B*Cin,
//      2*m1, re/im) (0.79 MB at the main shape, L2-resident).
//   S2 fno2d_mix_inverse_h      grid (m2/8 column tiles x mode-row slices, Cout, B/4),
//      128 threads, launched as clusters of the (up to 8) blocks that split one tile's
//      2*m1 mode rows. Each block mixes its 16-row slice of 8 mode columns for its 4
//      batch elements on the f32 cores, from weights staged once: every weight is read
//      by exactly one block (for B <= 4), in whole 32-byte sectors. It then multiplies
//      its slice into the inverse +-DFT along H, [Zr | Zi] += [Gxre^T | Gxim^T]_slice
//      Bm_slice (M=H, N=64, K=2*16), and the cluster sums the slices' partial products
//      through distributed shared memory, each block its share of the H rows, into Z
//      (B, Cout, H, m2, re/im) (0.93 MB at the main shape).
//   S3 fno2d_inverse_w<E>       grid (B*Cout, H/16 row tiles), 128 threads, launched as
//      clusters of up to 4 consecutive output channels' blocks. They share the W matrix
//      and the rows of x that the pointwise term reads: each block issues a share of
//      those rows as TMA bulk copies multicast to the whole cluster, which complete on an
//      mbarrier in each block, so L2 serves them once per cluster instead of once per
//      block. Bulk copies need rows of whole 16-byte pieces at aligned addresses; for
//      other shapes (W % 4 != 0) or unaligned tensors each block stages the matrix with
//      cp.async and the epilogue reads x from L2. It runs the inverse rDFT along W,
//      y = Z_rows [Gyre; Gyim] (M=16, N=W, K=2*m2, real and imaginary parts interleaved),
//      then the epilogue, 4 columns a thread: + pk^T x + pb and exact erf gelu (E: 0
//      spectral conv only, 1 + pointwise and bias, 2 + gelu).
// Why three launches: S2 needs every H row of a mode column for every input channel, and
// S3 every mode of a row, so the data dependence turns twice. Fusing S2 and S3 in one
// cluster would need all m2 columns of Z (0.93 MB) in one cluster's shared memory, far
// above 8 x 227 KB. The scratch between launches stays in L2. S2 and S3 are launched as
// programmatic dependents, so each stages its matrices (and S3 its rows of x) while the
// stage before finishes.
//
// Numerics: every transform runs as warp-level mma.sync.m16n8k8 TF32 products with
// 3xTF32 error compensation: each operand a splits as a_hi = cvt.rna.tf32(a),
// a_lo = cvt.rna.tf32(a - a_hi), and each tile accumulates a_lo*b_hi + a_hi*b_lo (one
// chain) and a_hi*b_hi (another) in f32. Single-pass TF32 misses the kernel tests' 3e-4
// (tests/test_torch_fno2d.py emulates both). The mix and the pointwise term stay on the
// f32 cores.
//
// Instruction issue, not the tensor cores, limits the products: splitting an operand
// takes several instructions, and the warps of an SM share its four schedulers. So an
// operand that several tiles read is split once: B2 and Bm are written already split
// (high and low planes), S3 splits its rows of Z once after staging them, and each warp
// runs 2 or 4 adjacent n-tiles against one split A fragment.
//
// Shared memory: operands are staged once per block, edges zero-padded to the mma tile
// (76 -> 80 rows and columns), with cp.async (16-byte copies where the rows are aligned,
// 4-byte ones elsewhere) or, in S3, the multicast bulk copies. Row strides are padded so
// that fragment loads hit 32 distinct banks: an operand read along its rows (element
// (g, t) at g*s + t) gets s = 4 mod 8, one read along its columns (at t*s + g) gets
// s = 8 mod 16.
//
// Fill at the main shape: S1 192 blocks of 109 KB, 2 per SM; S2 192 blocks of 64 KB in
// clusters of 4, 3 per SM; S3 240 blocks of 99 KB in clusters of 4, 2 per SM. Every
// stage runs in one wave with all blocks resident. S1 and S2 stay below 264 blocks: S1's
// shared memory holds two blocks per SM, and a finer column split would double the L2
// traffic of the staged planes and matrix; S2 at 2 batch elements or 8 mode rows a
// block (384 blocks) was tried and not kept (that probe is not in the repo). Registers, shared memory and spills of each
// kernel are printed by `-Xptxas -v` into the build log (chip_smoke.py phase `build`).
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W by blindno_torch/tools/ab_fno.py,
// which times variants of this source against each other in one process (medians of 10
// alternating rounds of CUDA-graph replays, main shape; PERF.md section 6): the layer
// with gelu 30.9 us, the spectral conv alone 27.7 us. With plain launches instead of
// programmatic dependents 32.9 and 29.1 us; torch.profiler then splits the gelu layer
// into S1 10.1, S2 13.0 and S3 10.6 us (S3 6.6 us for the spectral conv). With S3's
// matrix staged per block by cp.async instead of the multicast copies (and x read from
// L2) 34.3 and 30.2 us; with only the matrix multicast and x read from L2, 32.5 and
// 27.7 us. Each was slower than this design in all 10 rounds, save the spectral conv
// with x read from L2, which reads no x and so runs the same code.
// The layouts past the whole ones ("Shapes" below) are bound by their blocks' chains of
// loads and barriers, not by the card's rates (10-190x their bound by bytes), so they
// are laid out to fill the card. The same tool (--tiled: medians of 10 alternating rounds
// against the layouts before this design in the same process, same card) gives, gelu
// layer / spectral conv in us, before, and torch.fft's restatement of the layer:
// 200 x 200 at 64 x 64 modes 22.4 / 21.4 (67.2 / 63.7; 30.7 / 23.6), 232 x 232 with
// every mode kept 55.4 / 54.4 (106.5 / 103.9; 66.4 / 58.7), 16 x 3600 31.0 / 30.3
// (73.7 / 67.2; 88.6 / 41.8), 192 -> 12 channels at B = 2 164.6 / 137.6 (281.4 / 196.6;
// 252.8 / 216.3) and at B = 4 251.9 / 215.8 (334.3 / 236.1; 308.1 / 249.6), the fpe2d
// heads padded to 183 x 183 122.6 / 103.8 (180.4 / 109.9; 181.0 / 144.6). The models'
// shapes kept their layouts, each as fast as before or faster (by up to 2.9%).
// Tried and not kept: two accumulator chains a product for the tiled products (no
// change), 48-row or 32-row S1 chunks (up to 30% slower), half the mode rows a S1
// block at 200 x 200 (blocks packed two an SM: slower), a tiled S2 launched as a
// programmatic dependent of the tiled S1 (a fifth slower) and the tiled S1 as one where
// its grid takes more than one block an SM (16 x 3600: 38.5 against 30.7 us).
//
// Shapes: any B, Cin, Cout >= 1, any H and W, 1 <= m1 <= H/2 and 1 <= m2 <= W/2 + 1,
// every tensor indexable in 32 bits (the wrapper's guard, ops/spectral_cuda.py). The host
// plan (launch_layer) picks each stage's layout from the shape, the card's SM count and
// the kernels' occupancy. The models' layers (chip_smoke.py's MAIN_SHAPE, RAGGED_SHAPE,
// FIT_SHAPE, NCFPE2D_HEADS, NIOFNO2D_INNER, NCFPE2D_INNER and TP_SLICE: at most 12 input
// channels, grids up to 100 x 100 whose planes and matrices fit one block, whole-layout
// S2 blocks of at most 78 KB, S3 grids of 45 blocks or more) take the whole layouts of
// the design above at every stage; each other layout below is taken only past one of
// those bounds, and tests/test_torch_kernels_cuda.py holds each against the plain
// version (TILED_SHAPES).
//   S1. Whole, a block holds its x plane and the +-H matrix (where both do not fit, the
//       matrix in the plane's place after step 1): square grids up to 176 x 176 at
//       32 x 32 modes, 144 x 144 with every mode kept, 16 rows of up to 1408 points.
//       Tiled (fno2d_forward_transform_tiled), the plane comes in chunks of
//       hc = min(H, 64) rows by 4096/hc columns (64 by 64 at most), double-buffered by
//       cp.async; step 1 sums Y = X Fy over a row chunk's column chunks in registers, one
//       (row tile, n tile) a warp, and step 2 adds the row chunk's B2 against its rows of
//       the +-H matrix into S, in registers too. A block takes at most 256 mode rows (two
//       row tiles a warp); more, and the mode tiles run as blocks of their own beside the
//       column tiles (grid y and z). A block's chain of chunks, each a load, a barrier
//       and a small product, bounds this layout, not the card's rates: where the grid
//       would leave SMs idle, a cluster of cs = 2, 4 or 8 blocks (the largest whose grid
//       still fits on the card at once, at most one block a chunk) splits the plane's
//       chunks, in order, into cs runs that may cross row chunks (and where even 8 blocks
//       would take more than a chunk each, W chunks wide enough for one a block are
//       taken where they keep the cluster: 200 x 200 at 64 x 64 modes, 2 chunks of
//       64 x 104 a row chunk instead of 4 of 64 x 64). Each block keeps its
//       part of S in registers and sends each block of the cluster its share of the part
//       through distributed shared memory; after one cluster barrier each block sums its
//       share in rank order and writes it: no atomics, no launch more, the same sums in
//       every run. Where its grid takes one block an SM at most, the layout is a
//       programmatic dependent of the kernel before: it stages its first rows of the
//       +-H matrix (a constant) while that kernel ends, and reads x after the wait. At
//       most 224 KB (hc = 64, 256 mode rows).
//   S2. Whole, a block holds its slice of the inverse H matrix and its partial product
//       over every H row, and its slice of every input channel's weights: up to 175
//       input channels at the main shape (193 at B = 2), up to 480 rows. Past kChansS2
//       (64) input channels, each slice's channels split among the cluster's blocks
//       (slices x ranks <= 8: 2 ranks at 2*m1 = 64, so 98 KB of weights a block at 192
//       channels instead of 196), each mixing its run of channels with the loads of 8
//       channels in flight a thread, and the cluster sums every block's partial product,
//       slices and channel runs alike. Tiled (fno2d_mix_inverse_h_tiled), a block takes
//       its slice's mode rows 16 at a time: one mix item a thread, summed in registers
//       over chunks of 64 input channels' weights, then that row chunk's inverse product
//       added into the partial product of an H chunk of up to 256 rows; the cluster sums
//       each H chunk through distributed shared memory before the next, so an H chunk
//       past the first mixes again. At most 192 KB. It also takes the shapes whose whole
//       block would hold an SM alone where its own would not (232 x 232 with every mode
//       kept: 126 KB against 82), and is launched plainly.
//   S3. A block holds its 16 rows of Z and the W matrix for its output columns: all W,
//       or, where that does not fit (W past 672 at m2 = 32, or m2 past 88 at 232
//       points), a W tile of 256, 128, 64 or 32 columns (the tiles beside the row tiles
//       in grid y and z); where even 32 columns do not fit (m2 past 324), it takes
//       Z's columns and the matrix's rows in passes whose products add into y. Where one
//       pass takes all of Z's columns and the rows are whole 16-byte pieces, the
//       multicast bulk copies stay, W tile by W tile. The pointwise weights of at most
//       4096 input channels are staged; the epilogue reads the rest from L2.
//       Grouped (fno2d_inverse_w_grouped), where that layout would read x for the
//       pointwise term from L2 one column a thread (W % 4 != 0, unaligned rows) or over
//       more than kChansL2 (16) input channels, would leave three in four SMs idle, or
//       tiles W, and one pass takes all of Z's columns: a block takes up to kOut3 (4)
//       output channels of one batch element's row tile and W tile (all W up to 256
//       columns, halved down to 32 while the grid has fewer than two blocks an SM or two
//       blocks would not share an SM's shared memory). It stages the tile's W matrix
//       columns once for its channels, splits their rows of Z, and runs one product a
//       channel. The pointwise term then streams x's rows in chunks of input channels
//       (double-buffered by cp.async, 16-byte pieces where the rows allow, 4-byte ones
//       elsewhere, rows padded to whole 16-byte pieces in shared memory), and each thread
//       adds 4 columns of every staged channel into each output channel's row: x is read
//       once for kOut3 output channels, and its loads are in flight a chunk at a time
//       instead of one L2 round trip a channel. The chunk is as large as the shared
//       memory left allows. It lets the next kernel start once all its blocks have.
// Where the grid of S1 (column tiles) or S2 (output channels, batch groups) passes the y
// or z limit, that stage takes its tiled layout, whose grids fold their tiles over y and
// z (`folded`); S3's always do. PERF.md section 6 has every layout's times beside its
// bound and the torch.fft restatement's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using blindno::allow_smem;
using blindno::cp_async16;
using blindno::cp_async4;
using blindno::cp_async_commit;
using blindno::cp_async_wait;
using blindno::kMaxDevices;
using blindno::kMaxSmem;
using blindno::launch_cluster_grid;
using blindno::launch_clusters;
using blindno::launch_dependents;
using blindno::smem_addr;
using blindno::wait_prerequisites;

constexpr int kThreads1 = 256;  // threads of an S1, S2 and S3 block
constexpr int kThreads2 = 128;
constexpr int kThreads3 = 128;
constexpr int kCols1 = 8;     // S1: kept W-frequencies per block
constexpr int kS1 = 24;       // S1: row stride of its 16 real columns (re | im), 8 mod 16
constexpr int kCols2 = 8;     // S2: mode columns per block, one 32-byte weight sector
constexpr int kBatch2 = 4;    // S2: batch elements per block
constexpr int kSlice2 = 16;   // S2: mode rows per block, as a rule
constexpr int kCluster2 = 8;  // S2: largest cluster (the portable limit)
constexpr int kRows3 = 16;    // S3: output rows per block (one mma row tile)
constexpr int kBarFloats = 4;  // S3: room for its mbarrier ahead of the operands
// The tiled layouts, for shapes whose whole operands do not fit in a block (see the note)
constexpr int kRowsT1 = 64;     // S1: most rows of an H chunk
constexpr int kChunkT1 = 4096;  // S1: most floats of an x chunk (rows x columns)
constexpr int kModesT1 = 256;   // S1: most mode rows of a block (2 row tiles a warp)
constexpr int kCluster1 = 8;    // S1: most blocks splitting a plane's chunks
constexpr int kRowsT2 = 256;    // S2: most rows of an H chunk
constexpr int kChansT2 = 64;    // S2: input channels of a weight chunk
constexpr int kChansS2 = 64;    // S2: most input channels a block mixes without the split
constexpr int kPkStaged = 4096;  // S3: most pointwise weights staged; the rest read from L2
constexpr int kChansL2 = 16;     // S3: most input channels whose x rows it reads from L2
constexpr int kOut3 = 4;         // S3 grouped: most output channels of a block
constexpr int kTileG3 = 32;      // S3 grouped: least W tile
constexpr int kMaxGridYZ = 65535;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ constexpr int ceil_div(int n, int m) { return (n + m - 1) / m; }
// Row strides that keep a warp's fragment loads conflict-free (see the note above).
__host__ __device__ constexpr int stride_rows(int n) {  // read as (g, t) -> g*s + t
  return round_up(n, 8) + 4;
}
__host__ __device__ constexpr int stride_cols(int n) {  // read as (g, t) -> t*s + g
  return round_up(n, 16) + 8;
}

struct Shape {
  int B, Cin, Cout, H, W, K, m2;
  int Hp8, Hp16, Wp8, Kp16, J;  // padded: rows, mma row tiles, W, modes, 2*m2
};

// A grid of x blocks by n tiles, the tiles over y and z where n exceeds the y limit; a
// block's tile is folded_tile(), and blocks past n return at once.
dim3 folded(unsigned x, int n) {
  const int y = n < kMaxGridYZ ? n : kMaxGridYZ;
  return dim3(x, y, ceil_div(n, y));
}

__device__ __forceinline__ int folded_tile() { return blockIdx.z * gridDim.y + blockIdx.y; }

// ---- cp.async staging ------------------------------------------------------------------

// Copy rows [0, rows) x columns [0, cols) of a row-major global matrix (row stride
// `ss`) into shared memory (row stride `ds`), zero-filling up to rows_pad x cols_pad
// (cols_pad a multiple of 4). All threads of the block take part; the copies land
// after the next cp_async_wait and __syncthreads.
__device__ void stage_rows(float* dst, int ds, const float* src, int ss, int rows, int cols,
                           int rows_pad, int cols_pad) {
  const bool vec = ss % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    const int c4 = cols_pad / 4;
    for (int i = threadIdx.x; i < rows_pad * c4; i += blockDim.x) {
      const int r = i / c4, c = (i % c4) * 4;
      float* d = dst + r * ds + c;
      const int n = r < rows ? min(4, cols - c) : 0;
      if (n > 0)
        cp_async16(d, src + size_t(r) * ss + c, 4 * n);  // zero-fills past n floats
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < rows_pad * cols_pad; i += blockDim.x) {
      const int r = i / cols_pad, c = i % cols_pad;
      if (r < rows && c < cols)
        cp_async4(dst + r * ds + c, src + size_t(r) * ss + c);
      else
        dst[r * ds + c] = 0.f;
    }
  }
}

// stage_rows for the tiled and grouped layouts: where the rows are not whole 16-byte
// pieces and at least 32 columns long, a warp takes a row, its lanes along it, so that no
// copy costs a division.
__device__ void stage_rows_t(float* dst, int ds, const float* src, int ss, int rows, int cols,
                             int rows_pad, int cols_pad) {
  const bool vec = ss % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec || cols_pad < 32) {
    stage_rows(dst, ds, src, ss, rows, cols, rows_pad, cols_pad);
    return;
  }
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows_pad; r += warps)
    for (int c = lane; c < cols_pad; c += 32) {
      if (r < rows && c < cols)
        cp_async4(dst + r * ds + c, src + size_t(r) * ss + c);
      else
        dst[r * ds + c] = 0.f;
    }
}

// Zero what stage_rows would zero around a rows x cols block: columns [cols, cols_pad)
// of its rows, and rows [rows, rows_pad).
__device__ void zero_pad(float* dst, int ds, int rows, int cols, int rows_pad, int cols_pad) {
  const int extra = cols_pad - cols;
  for (int i = threadIdx.x; i < rows * extra; i += blockDim.x)
    dst[(i / extra) * ds + cols + i % extra] = 0.f;
  for (int i = threadIdx.x; i < (rows_pad - rows) * cols_pad; i += blockDim.x)
    dst[(rows + i / cols_pad) * ds + i % cols_pad] = 0.f;
}

// ---- bulk copies multicast over a thread-block cluster (TMA) ------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival on `bar`, announcing the bytes that its phase waits for.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state)
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
}

// Copy rows [0, rows) of `cols` floats (global row stride `ss`) into shared rows of stride
// `ds` in every block of the cluster: the blocks deal the rows out among themselves and
// each row is one bulk copy, multicast to all of them and counted on `bar`, which sits at
// the same offset in each. cols*4 bytes, and every row's address, are multiples of 16.
__device__ void multicast_rows(float* dst, int ds, const float* src, int ss, int rows,
                               int cols, uint64_t* bar, int rank, int csize) {
  const unsigned short mask = static_cast<unsigned short>((1u << csize) - 1);
  for (int r = rank + csize * int(threadIdx.x); r < rows; r += csize * int(blockDim.x))
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst + r * ds)),
        "l"(src + size_t(r) * ss), "r"(cols * 4), "r"(smem_addr(bar)), "h"(mask)
        : "memory");
}

// ---- 3xTF32 warp tiles -----------------------------------------------------------------

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// Store v into a pre-split operand: its TF32 high part at p, its low part at p + lo.
__device__ __forceinline__ void store_split(float* p, int lo, float v) {
  uint32_t h, l;
  split_tf32(v, h, l);
  p[0] = __uint_as_float(h);
  p[lo] = __uint_as_float(l);
}

template <bool kPre>
__device__ __forceinline__ void load_split(const float* p, int lo, uint32_t& h, uint32_t& l) {
  if (kPre) {
    h = __float_as_uint(p[0]);
    l = __float_as_uint(p[lo]);
  } else {
    split_tf32(p[0], h, l);
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: the NT adjacent 16x8 tiles D_j = A B_j over k in [0, kdim) (a multiple of
// 8), with A(r, k) = A[r*a_rs + k*a_cs] and B(k, n) = B[k*b_rs + n*b_cs] in shared
// memory, the pointers at the tiles' origin, B_j at column 8j. An operand marked
// pre-split holds its TF32 high parts there and its low parts `lo` floats further.
// Returns the fragments: d[j][0], d[j][1] at row g, columns 2t and 2t+1 of tile j;
// d[j][2], d[j][3] at row g+8 (g = lane/4, t = lane%4).
template <int NT, bool kAPre, bool kBPre>
__device__ __forceinline__ void warp_tiles(float (&d)[NT][4], const float* A, int a_rs,
                                           int a_cs, int a_lo, const float* B, int b_rs,
                                           int b_cs, int b_lo, int kdim) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float c[NT][4];  // the correction terms a_lo b_hi + a_hi b_lo, their own chain
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = c[j][i] = 0.f;
  const float* a = A + g * a_rs + t * a_cs;
  const float* b = B + t * b_rs + g * b_cs;
  const int a_off[4] = {0, 8 * a_rs, 4 * a_cs, 8 * a_rs + 4 * a_cs};
#pragma unroll 2
  for (int k = 0; k < kdim; k += 8) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_split<kAPre>(a + a_off[i], a_lo, ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2];
      load_split<kBPre>(b + j * 8 * b_cs, b_lo, bh[0], bl[0]);
      load_split<kBPre>(b + j * 8 * b_cs + 4 * b_rs, b_lo, bh[1], bl[1]);
      mma_tf32(c[j], al, bh);
      mma_tf32(c[j], ah, bl);
      mma_tf32(d[j], ah, bh);
    }
    a += 8 * a_cs;
    b += 8 * b_rs;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] += c[j][i];
}

// ---- S1: forward transforms ------------------------------------------------------------

// Write the spectrum tile st (mc kept columns, each a run of 2*kc floats: mode rows
// [k0, k0 + kc) as re/im pairs; k0 and kc even) into the scratch, as whole float4.
__device__ __forceinline__ void write_spectrum(float* __restrict__ spec, const float* st,
                                               const Shape& s, int plane, int m0, int mc,
                                               int k0, int kc) {
  const int row4 = kc / 2, stride4 = s.K / 2;
  float4* spec4 = reinterpret_cast<float4*>(spec);
  const float4* st4 = reinterpret_cast<const float4*>(st);
  for (int i = threadIdx.x; i < mc * row4; i += kThreads1) {
    const int c = i / row4, r = i % row4;
    spec4[(size_t(m0 + c) * s.B * s.Cin + plane) * stride4 + k0 / 2 + r] = st4[c * row4 + r];
  }
}

// Shared-memory layout of S1, in floats from the start of the block's buffer.
struct Layout1 {
  int xs_s, fx_s;      // row strides of the x plane and of the +-H matrix
  int off_b2, off_fx;  // offsets of the step-2 right operand (split) and of the matrix
  int b2_lo;           // offset of B2's low parts from its high parts
  int fx_after;        // 1: the matrix takes the x plane's place after step 1
  size_t bytes;
};

Layout1 layout1(const Shape& s) {
  Layout1 L;
  L.xs_s = stride_rows(s.Wp8);
  L.fx_s = stride_cols(s.Kp16);
  const size_t xs = size_t(s.Hp16) * L.xs_s, fy = size_t(s.Wp8) * kS1;
  const size_t b2 = size_t(2) * s.Hp8 * kS1, fx = size_t(2) * s.Hp8 * L.fx_s;
  const size_t st = size_t(2) * kCols1 * s.K;  // the spectrum tile on its way out
  auto larger = [](size_t a, size_t b) { return a > b ? a : b; };
  L.b2_lo = int(b2);
  L.fx_after = (larger(xs + fy, st) + 2 * b2 + fx) * sizeof(float) > kMaxSmem;
  const size_t region0 = L.fx_after ? larger(larger(xs + fy, fx), st) : larger(xs + fy, st);
  L.off_b2 = int(region0);
  L.off_fx = L.fx_after ? 0 : int(region0 + 2 * b2);
  L.bytes = (region0 + 2 * b2 + (L.fx_after ? 0 : fx)) * sizeof(float);
  return L;
}

__global__ void __launch_bounds__(kThreads1) fno2d_forward_transform(
    const float* __restrict__ x,                                      // (B, Cin, H, W)
    const float* __restrict__ fyre, const float* __restrict__ fyim,   // (W, m2)
    const float* __restrict__ fxre, const float* __restrict__ fxim,   // (H, K)
    float* __restrict__ spec,                                         // (m2, B*Cin, K, 2)
    Shape s, Layout1 L) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                    // Hp16 x xs_s: A1(h, w)
  float* fy = smem + s.Hp16 * L.xs_s;  // Wp8 x kS1: B1(w, n), re | im columns
  float* b2 = smem + L.off_b2;         // 2*Hp8 x kS1, split: [[Yr, Yi], [-Yi, Yr]]
  float* fx = smem + L.off_fx;         // 2*Hp8 x fx_s: fx[kk][k] = A2(k, kk)
  float* st = smem;                    // kCols1 x K x 2: the spectrum tile, at the end
  const int plane = blockIdx.x, m0 = blockIdx.y * kCols1;
  const int mc = min(kCols1, s.m2 - m0);
  constexpr int kWarps1 = kThreads1 / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  launch_dependents();
  stage_rows(xs, L.xs_s, x + size_t(plane) * s.H * s.W, s.W, s.H, s.W, s.Hp16, s.Wp8);
  stage_rows(fy, kS1, fyre + m0, s.m2, s.W, mc, s.Wp8, kCols1);
  stage_rows(fy + kCols1, kS1, fyim + m0, s.m2, s.W, mc, s.Wp8, kCols1);
  cp_async_commit();
  if (!L.fx_after) {  // the matrix comes in while step 1 runs
    stage_rows(fx, L.fx_s, fxre, s.K, s.H, s.K, s.Hp8, s.Kp16);
    stage_rows(fx + s.Hp8 * L.fx_s, L.fx_s, fxim, s.K, s.H, s.K, s.Hp8, s.Kp16);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // step 1: Y = X Fy (rows h past H are zero, since the plane is zero-padded), stored
  // split into B2's four blocks
  for (int mt = warp; mt < s.Hp16 / 16; mt += kWarps1) {
    float d[2][4];
    warp_tiles<2, false, false>(d, xs + mt * 16 * L.xs_s, L.xs_s, 1, 0, fy, kS1, 1, 0, s.Wp8);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = mt * 16 + g + (i >> 1) * 8, n = 2 * t + (i & 1);
        if (h >= s.Hp8) continue;
        store_split(b2 + h * kS1 + j * kCols1 + n, L.b2_lo, d[j][i]);
        store_split(b2 + (s.Hp8 + h) * kS1 + (1 - j) * kCols1 + n, L.b2_lo,
                    j == 0 ? d[j][i] : -d[j][i]);
      }
  }
  if (L.fx_after) {
    __syncthreads();  // the plane is dead: the matrix takes its place
    stage_rows(fx, L.fx_s, fxre, s.K, s.H, s.K, s.Hp8, s.Kp16);
    stage_rows(fx + s.Hp8 * L.fx_s, L.fx_s, fxim, s.K, s.H, s.K, s.Hp8, s.Kp16);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // step 2: [Sr | Si] = [Fxre^T | Fxim^T] B2, kept in registers until every warp is done
  // with the matrix, whose place (or the plane's) then holds the tile on its way out. A
  // warp takes at most two row tiles: the matrix alone, 2H x (2*m1 + 8) floats, fits in
  // shared memory only for 2*m1 <= 166.
  const int mtiles = s.Kp16 / 16;
  float d[2][2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (warp + q * kWarps1 < mtiles)
      warp_tiles<2, false, true>(d[q], fx + (warp + q * kWarps1) * 16, 1, L.fx_s, 0, b2, kS1,
                                 1, L.b2_lo, 2 * s.Hp8);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (warp + q * kWarps1 < mtiles)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = (warp + q * kWarps1) * 16 + g + (i >> 1) * 8, c = 2 * t + (i & 1);
          if (k < s.K) st[(c * s.K + k) * 2 + j] = d[q][j][i];
        }
  __syncthreads();
  // each kept column's spectrum is one contiguous row of 2*K floats (K is even)
  write_spectrum(spec, st, s, plane, m0, mc, 0, s.K);
}

// S1 in chunks, where the whole plane and matrix do not fit (the note above): rows of an H
// chunk by columns of a W chunk of the plane, double-buffered; the +-H matrix's rows of
// the H chunk; at most kModesT1 mode rows a block (grid z with y: column tiles x mode
// tiles). Step 1 sums Y over the W chunks in registers, step 2 sums S over the H chunks.
// Where the grid alone would leave SMs idle, a cluster of cs blocks splits the plane's
// chunks (H chunk by W chunk, in order) into cs runs, one a block, and sums the blocks'
// parts of S through distributed shared memory.
struct Tiled1 {
  int hc, wc, kt;       // rows of an H chunk, columns of a W chunk, mode rows of a block
  int xs_s, fx_s;       // row strides of an x chunk and of a matrix chunk
  int off_fy, off_b2, off_fx, off_recv, b2_lo;
  int col_tiles, tiles;  // tiles of kept columns; of columns x mode rows
  int chunks, cs;       // chunks of a plane; blocks of a cluster (1, 2, 4 or 8)
  size_t bytes;
};

// `wc` > 0: W chunks of wc columns instead of kChunkT1 / hc.
Tiled1 tiled1(const Shape& s, int wc = 0) {
  Tiled1 L;
  L.hc = min(s.Hp16, kRowsT1);
  L.wc = min(s.Wp8, wc > 0 ? wc : kChunkT1 / L.hc / 8 * 8);
  L.kt = min(s.Kp16, kModesT1);
  L.xs_s = stride_rows(L.wc);
  L.fx_s = stride_cols(L.kt);
  const int xs = 2 * L.hc * L.xs_s, fy = 2 * L.wc * kS1, b2 = 2 * L.hc * kS1;
  L.off_fy = xs;  // the x buffers hold the spectrum tile at the end: 16*kt <= 2*hc*xs_s
  L.off_b2 = xs + fy;
  L.b2_lo = b2;
  L.off_fx = L.off_b2 + 2 * b2;
  L.col_tiles = ceil_div(s.m2, kCols1);
  L.tiles = L.col_tiles * ceil_div(s.K, L.kt);
  L.chunks = ceil_div(s.W, L.wc) * ceil_div(s.H, L.hc);
  L.cs = 1;
  L.off_recv = L.off_fx + 2 * L.hc * L.fx_s;  // the cluster's parts of S, write_spectrum_summed
  L.bytes = (size_t(L.off_recv) + 16 * L.kt + 4 * kCluster1) * sizeof(float);
  return L;
}

// The largest cluster (a power of two up to kCluster1, at most one block a chunk) whose
// blocks all fit on the card at once beside the grid's other clusters, given `resident`
// blocks an SM.
int split1(const Shape& s, const Tiled1& L, int sms, int resident) {
  const long blocks = long(s.B) * s.Cin * L.tiles, room = long(sms) * resident;
  int cs = 1;
  while (2 * cs <= kCluster1 && 2 * cs <= L.chunks && blocks * 2 * cs <= room) cs *= 2;
  return cs;
}

// Sum the cluster's spectrum tiles st (each block's part of S, laid out as write_spectrum
// reads it) and write them as write_spectrum does. Block o owns share o of the tile's
// float4s: every block sends it its part of that share, into slot `rank` of o's `recv`
// (cs slots, a region of its own that no block uses before), and after one cluster
// barrier o sums its slots in rank order and writes them. No block touches another's
// shared memory after the barrier, so none waits for the others to leave.
__device__ __forceinline__ void write_spectrum_summed(float* __restrict__ spec, const float* st,
                                                      float4* recv, const Shape& s, int plane,
                                                      int m0, int mc, int k0, int kc, int rank,
                                                      int cs) {
  cg::cluster_group cluster = cg::this_cluster();
  const int row4 = kc / 2, stride4 = s.K / 2, n4 = mc * row4, share = ceil_div(n4, cs);
  const float4* st4 = reinterpret_cast<const float4*>(st);
  for (int i = threadIdx.x; i < n4; i += kThreads1) {
    const int owner = i / share;
    cluster.map_shared_rank(recv, owner)[rank * share + i - owner * share] = st4[i];
  }
  cluster.sync();  // every part is with its share's owner
  float4* spec4 = reinterpret_cast<float4*>(spec);
  const int lo = rank * share, hi = min(n4, lo + share);
  for (int i = lo + threadIdx.x; i < hi; i += kThreads1) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < cs; ++r) {
      const float4 v = recv[r * share + i - lo];
      a.x += v.x, a.y += v.y, a.z += v.z, a.w += v.w;
    }
    const int c = i / row4, q = i % row4;
    spec4[(size_t(m0 + c) * s.B * s.Cin + plane) * stride4 + k0 / 2 + q] = a;
  }
}

__global__ void __launch_bounds__(kThreads1) fno2d_forward_transform_tiled(
    const float* __restrict__ x,                                      // (B, Cin, H, W)
    const float* __restrict__ fyre, const float* __restrict__ fyim,   // (W, m2)
    const float* __restrict__ fxre, const float* __restrict__ fxim,   // (H, K)
    float* __restrict__ spec,                                         // (m2, B*Cin, K, 2)
    Shape s, Tiled1 L) {
  extern __shared__ __align__(16) float smem[];
  const int tile = folded_tile();
  if (tile >= L.tiles) return;  // the whole cluster: it spans blockIdx.x only
  float* b2 = smem + L.off_b2;  // 2*hc x kS1, split: the H chunk's [[Yr, Yi], [-Yi, Yr]]
  float* fx = smem + L.off_fx;  // 2*hc x fx_s: fx[kk][k] = A2(k0 + k, h0 + kk)
  const int plane = blockIdx.x / L.cs, rank = blockIdx.x % L.cs;  // rank in the cluster
  const int m0 = (tile % L.col_tiles) * kCols1, k0 = (tile / L.col_tiles) * L.kt;
  const int mc = min(kCols1, s.m2 - m0), kc = min(L.kt, s.K - k0);
  constexpr int kWarps1 = kThreads1 / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w_chunks = ceil_div(s.W, L.wc);
  // this block's run of the plane's chunks: at least one, since cs <= chunks
  const int first = rank * L.chunks / L.cs, last = (rank + 1) * L.chunks / L.cs;
  const float* xp = x + size_t(plane) * s.H * s.W;
  auto xs = [&](int i) { return smem + (i & 1) * L.hc * L.xs_s; };
  auto fy = [&](int i) { return smem + L.off_fy + (i & 1) * L.wc * kS1; };

  // chunk i of the plane (H chunk i / w_chunks, W chunk i % w_chunks) and the W matrices'
  // rows of its columns, into buffer i % 2
  auto stage_chunk = [&](int i) {
    const int h0 = (i / w_chunks) * L.hc, w0 = (i % w_chunks) * L.wc;
    const int wn = min(L.wc, s.W - w0);
    stage_rows_t(xs(i), L.xs_s, xp + size_t(h0) * s.W + w0, s.W, min(L.hc, s.H - h0), wn, L.hc,
                 L.wc);
    stage_rows_t(fy(i), kS1, fyre + size_t(w0) * s.m2 + m0, s.m2, wn, mc, L.wc, kCols1);
    stage_rows_t(fy(i) + kCols1, kS1, fyim + size_t(w0) * s.m2 + m0, s.m2, wn, mc, L.wc,
                 kCols1);
    cp_async_commit();
  };
  // H chunk hi's rows of the +-H matrix
  auto stage_fx = [&](int hi) {
    const int h0 = hi * L.hc, hn = min(L.hc, s.H - h0);
    stage_rows_t(fx, L.fx_s, fxre + size_t(h0) * s.K + k0, s.K, hn, kc, L.hc, L.kt);
    stage_rows_t(fx + L.hc * L.fx_s, L.fx_s, fxim + size_t(h0) * s.K + k0, s.K, hn, kc, L.hc,
                 L.kt);
    cp_async_commit();
  };
  // The +-H matrix is a constant, written once by a host copy when the wrapper caches it:
  // its first chunk comes in while the kernel before (a layer's S3, say) may still run.
  // Nothing else is read or written before the wait, and S2 is let start only after it,
  // so no later stage of this call runs beside the kernel before.
  const int h_first = first / w_chunks;
  stage_fx(h_first);
  wait_prerequisites();
  launch_dependents();
  stage_chunk(first);

  // step 1: each warp one (row tile, n tile) of the H chunk's Y (hc <= 64: 8 tasks at
  // most); step 2: each warp at most two row tiles of S (kt <= 256), summed over H chunks
  const int mt1 = warp >> 1, j1 = warp & 1, mtiles = L.kt / 16;
  const bool step1 = mt1 < L.hc / 16;
  float acc[2][2][4] = {};
  for (int i = first; i < last;) {
    const int hi = i / w_chunks;
    if (hi != h_first) stage_fx(hi);
    float y[4] = {0.f, 0.f, 0.f, 0.f};  // this block's part of the H chunk's Y
    for (; i < last && i / w_chunks == hi; ++i) {
      // the next chunk comes in while this one is multiplied; the wait also lands the
      // matrix chunk, committed before it
      if (i + 1 < last) {
        stage_chunk(i + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (step1) {
        float d[1][4];
        warp_tiles<1, false, false>(d, xs(i) + mt1 * 16 * L.xs_s, L.xs_s, 1, 0,
                                    fy(i) + j1 * kCols1, kS1, 1, 0, L.wc);
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] += d[0][e];
      }
      __syncthreads();  // buffer i % 2 is free for chunk i + 2
    }
    if (step1)  // rows past H are zero, since the plane's are
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = mt1 * 16 + g + (e >> 1) * 8, n = 2 * t + (e & 1);
        store_split(b2 + h * kS1 + j1 * kCols1 + n, L.b2_lo, y[e]);
        store_split(b2 + (L.hc + h) * kS1 + (1 - j1) * kCols1 + n, L.b2_lo,
                    j1 == 0 ? y[e] : -y[e]);
      }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (warp + q * kWarps1 < mtiles) {
        float d[2][4];
        warp_tiles<2, false, true>(d, fx + (warp + q * kWarps1) * 16, 1, L.fx_s, 0, b2, kS1, 1,
                                   L.b2_lo, 2 * L.hc);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][j][e] += d[j][e];
      }
    __syncthreads();  // the matrix and B2 are free for the next H chunk
  }

  float* st = smem;  // kCols1 x kc x 2, where the x buffers were
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if (warp + q * kWarps1 < mtiles)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = (warp + q * kWarps1) * 16 + g + (e >> 1) * 8, c = 2 * t + (e & 1);
          if (k < kc) st[(c * kc + k) * 2 + j] = acc[q][j][e];
        }
  __syncthreads();
  if (L.cs == 1) {
    write_spectrum(spec, st, s, plane, m0, mc, k0, kc);
  } else {
    write_spectrum_summed(spec, st, reinterpret_cast<float4*>(smem + L.off_recv), s, plane,
                          m0, mc, k0, kc, rank, L.cs);
  }
}

// The tiled S1's layout at W chunks of wc columns (0: kChunkT1 / hc), its cluster fitted
// to the card's `sms` SMs at the occupancy its shared memory allows.
cudaError_t fit_tiled1(const Shape& s, int wc, int sms, int device, bool* raised, Tiled1& L) {
  L = tiled1(s, wc);
  cudaError_t err = allow_smem(fno2d_forward_transform_tiled, L.bytes, device, raised);
  int resident = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fno2d_forward_transform_tiled,
                                                        kThreads1, L.bytes);
  L.cs = split1(s, L, sms, max(1, resident));
  return err;
}

// ---- S2: mode mix and inverse +-DFT along H, one cluster per column tile ------------------

// Stage the weights of input channels [c0, c0 + cn), output channel o: rows [k0, k0 + kc)
// of each (K, m2) plane, mode columns [m0, m0 + mc), into rows of kCols2 floats,
// wsr[(c - c0) * rows + k] (rows past kc and columns past mc zero), as 16-byte pieces
// where the rows allow.
__device__ __forceinline__ void stage_weights(float* wsr, float* wsi, int rows,
                                              const float* __restrict__ wr,
                                              const float* __restrict__ wi, const Shape& s,
                                              int o, int c0, int cn, int k0, int kc, int m0,
                                              int mc) {
  const bool wvec = s.m2 % 4 == 0 && ((reinterpret_cast<uintptr_t>(wr) |
                                       reinterpret_cast<uintptr_t>(wi)) & 15) == 0;
  for (int i = threadIdx.x; i < cn * rows * 2; i += kThreads2) {
    const int c = i / (2 * rows), k = (i / 2) % rows, e0 = (i % 2) * 4;
    const int n = k < kc ? min(4, mc - e0) : 0;
    const size_t q = ((size_t(c0 + c) * s.Cout + o) * s.K + k0 + k) * s.m2 + m0 + e0;
    float* dr = wsr + (c * rows + k) * kCols2 + e0;
    float* di = wsi + (c * rows + k) * kCols2 + e0;
    if (wvec && n > 0) {
      cp_async16(dr, wr + q, 4 * n);
      cp_async16(di, wi + q, 4 * n);
    } else {
      for (int e = 0; e < 4; ++e) {
        if (e < n) {
          cp_async4(dr + e, wr + q + e);
          cp_async4(di + e, wi + q + e);
        } else {
          dr[e] = di[e] = 0.f;
        }
      }
    }
  }
}

// One item of the mix, summed over cn input channels: sp at the first channel's (re, im)
// of the item's first batch element (nb of 4 present, b_stride apart, channels K apart),
// ur and ui at that channel's staged weights (w_step floats a channel). The spectrum is
// read through L2 (ld.global.cg), not the read-only path: S1 wrote it during this grid's
// lifetime.
// With U > 4, the loads of U channels are issued before any of their products, so that
// more of them are in flight where a block walks many channels.
template <int U = 4>
__device__ __forceinline__ void mix_item(float (&ar)[4], float (&ai)[4], const float2* sp,
                                         size_t b_stride, int K, const float* ur_s,
                                         const float* ui_s, int w_step, int cn, int nb) {
  int c = 0;
  if constexpr (U > 4) {
    for (; c + U <= cn; c += U) {
      float2 v[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nb) v[u][j] = __ldcg(sp + j * b_stride + size_t(c + u) * K);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float ur = ur_s[(c + u) * w_step], ui = ui_s[(c + u) * w_step];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nb) {
            ar[j] = fmaf(v[u][j].x, ur, fmaf(-v[u][j].y, ui, ar[j]));
            ai[j] = fmaf(v[u][j].x, ui, fmaf(v[u][j].y, ur, ai[j]));
          }
      }
    }
  }
#pragma unroll 4
  for (; c < cn; ++c) {
    const float ur = ur_s[c * w_step], ui = ui_s[c * w_step];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < nb) {
        const float2 v = __ldcg(sp + j * b_stride + size_t(c) * K);
        ar[j] = fmaf(v.x, ur, fmaf(-v.y, ui, ar[j]));
        ai[j] = fmaf(v.x, ui, fmaf(v.y, ur, ai[j]));
      }
    }
  }
}

// Store an item's mixed values, split, into Bm = [[Or, Oi], [-Oi, Or]] (rows of each half).
__device__ __forceinline__ void store_mixed(float* bm, int bm_s, int bm_lo, int rows, int k,
                                            int mm, int grp, int bt, const float (&ar)[4],
                                            const float (&ai)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int bb = grp * 4 + j;
    if (bb < bt) {
      const int n = (bb * kCols2 + mm) * 2;
      store_split(bm + k * bm_s + n, bm_lo, ar[j]);
      store_split(bm + k * bm_s + n + 1, bm_lo, ai[j]);
      store_split(bm + (rows + k) * bm_s + n, bm_lo, -ai[j]);
      store_split(bm + (rows + k) * bm_s + n + 1, bm_lo, ar[j]);
    }
  }
}

// Sum rows [lo, hi) of the cluster's parts zp over its blocks and store each (batch,
// row)'s run of mode columns as row h_base + h of Z.
__device__ __forceinline__ void sum_parts(cg::cluster_group& cluster, float* zp, int zp_s,
                                          int slices, int lo, int hi, int h_base, int n_cols,
                                          float* __restrict__ z, const Shape& s, int o, int b0,
                                          int m0, int mc) {
  const int q4 = n_cols / 4;
  const bool whole = mc == kCols2 && s.m2 % 2 == 0;  // 16-byte aligned runs of 16 floats
  for (int i = threadIdx.x; i < max(0, hi - lo) * q4; i += kThreads2) {
    const int h = lo + i / q4, n = (i % q4) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < slices; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(zp, r) + h * zp_s + n);
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    const int bb = n / (2 * kCols2), j = n % (2 * kCols2), b = b0 + bb;  // j: 2*mm + part
    if (b >= s.B) continue;
    float* zr = z + (((size_t(b) * s.Cout + o) * s.H + h_base + h) * s.m2 + m0) * 2;
    if (whole) {
      *reinterpret_cast<float4*>(zr + j) = acc;
    } else {
      const float a[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int e = 0; e < 4; ++e)
        if ((j + e) / 2 < mc) zr[j + e] = a[e];
    }
  }
}

struct Layout2 {
  int slices, ks;  // mode-row slices of a cluster, rows of a slice
  int cranks, cn;  // blocks of a slice in a cluster, input channels of one
  int bt;          // batch elements per block (even: 16*bt columns, 4 n-tiles a warp)
  int gx_s, bm_s, zp_s;
  int off_bm, off_w, off_zp;
  size_t bytes;
};

// `cranks` blocks of a cluster share each slice, each mixing its run of cn input
// channels: a cluster of slices x cranks blocks (at most kCluster2).
Layout2 layout2(const Shape& s, int cranks) {
  Layout2 L;
  L.slices = min(kCluster2, (s.K + kSlice2 - 1) / kSlice2);
  L.cranks = cranks;
  L.cn = ceil_div(s.Cin, cranks);
  L.ks = round_up((s.K + L.slices - 1) / L.slices, 8);
  L.bt = min(kBatch2, round_up(s.B, 2));
  const int n = 2 * kCols2 * L.bt;  // (batch, mode column, re/im)
  L.gx_s = stride_cols(s.Hp16);
  L.bm_s = stride_cols(n);
  L.zp_s = round_up(n, 32) + 8;     // 8-byte stores of a half-warp on distinct banks
  L.off_bm = 2 * L.ks * L.gx_s;
  L.off_w = L.off_bm + 2 * (2 * L.ks * L.bm_s);
  L.off_zp = L.off_w + 2 * L.cn * L.ks * kCols2;
  L.bytes = (size_t(L.off_zp) + size_t(s.Hp16) * L.zp_s) * sizeof(float);
  return L;
}

// kSplit: the slices' input channels split among L.cranks blocks each (the note above),
// whose mix issues the loads of 8 channels at a time; else every block mixes all of them.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads2) fno2d_mix_inverse_h(
    const float* spec,  // (m2, B*Cin, K, 2), written by S1 while this grid may be running
    const float* __restrict__ wr, const float* __restrict__ wi,      // (Cin, Cout, K, m2)
    const float* __restrict__ gxre, const float* __restrict__ gxim,  // (K, H)
    float* __restrict__ z,                                           // (B, Cout, H, m2, 2)
    Shape s, Layout2 L) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int slice = kSplit ? rank % L.slices : rank;  // this block's mode-row slice
  const int parts = kSplit ? L.slices * L.cranks : L.slices;  // blocks of the cluster
  const int c0 = kSplit ? (rank / L.slices) * L.cn : 0;  // and its input channels
  const int cn = kSplit ? max(0, min(L.cn, s.Cin - c0)) : s.Cin;
  const int ks = L.ks, n_cols = 2 * kCols2 * L.bt;
  float* gx = smem;                            // 2*ks x gx_s: gx[kk][h] = A3(h, kk)
  float* bm = smem + L.off_bm;                 // 2*ks x bm_s, split: [[Or, Oi], [-Oi, Or]]
  const int bm_lo = 2 * ks * L.bm_s;
  float* wsr = smem + L.off_w;                 // cn x ks x kCols2: the slice's weights
  float* wsi = wsr + L.cn * ks * kCols2;
  float* zp = smem + L.off_zp;                 // Hp16 x zp_s: this block's part of Z
  const int m0 = (blockIdx.x / parts) * kCols2, o = blockIdx.y, b0 = blockIdx.z * L.bt;
  const int k0 = slice * ks, kc = max(0, min(ks, s.K - k0)), mc = min(kCols2, s.m2 - m0);
  constexpr int kWarps2 = kThreads2 / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  stage_rows(gx, L.gx_s, gxre + size_t(k0) * s.H, s.H, kc, s.H, ks, s.Hp16);
  stage_rows(gx + ks * L.gx_s, L.gx_s, gxim + size_t(k0) * s.H, s.H, kc, s.H, ks, s.Hp16);
  stage_weights(wsr, wsi, ks, wr, wi, s, o, c0, cn, k0, kc, m0, mc);
  cp_async_commit();
  launch_dependents();
  wait_prerequisites();  // the spectrum is S1's
  cp_async_wait<0>();
  __syncthreads();

  // the per-mode complex mix on the f32 cores: an item is one (mode row, mode column,
  // group of 4 batch elements); lanes run along the rows, which are contiguous in the
  // spectrum, and the spectrum loads of several input channels are in flight at once
  const float2* spec2 = reinterpret_cast<const float2*>(spec);
  const size_t b_stride = size_t(s.Cin) * s.K;
  const int groups = (L.bt + 3) / 4;
  for (int item = threadIdx.x; item < ks * kCols2 * groups; item += kThreads2) {
    const int k = item % ks, rest = item / ks;
    const int mm = rest % kCols2, grp = rest / kCols2, m = m0 + mm;
    const int nb = max(0, min(min(4, L.bt - grp * 4), s.B - b0 - grp * 4));
    float ar[4] = {0.f, 0.f, 0.f, 0.f}, ai[4] = {0.f, 0.f, 0.f, 0.f};
    if (k < kc && m < s.m2)
      mix_item<kSplit ? 8 : 4>(
          ar, ai, spec2 + (size_t(m) * s.B + b0 + grp * 4) * b_stride + size_t(c0) * s.K + k0 + k,
          b_stride, s.K, wsr + k * kCols2 + mm, wsi + k * kCols2 + mm, ks * kCols2, cn, nb);
    store_mixed(bm, L.bm_s, bm_lo, ks, k, mm, grp, L.bt, ar, ai);
  }
  __syncthreads();

  // this slice's part of [Zr | Zi] = [Gxre^T | Gxim^T] Bm: columns 2p, 2p+1 are Zr, Zi
  // of pair p = (batch, mode column)
  const int ngroups = n_cols / 32;  // groups of 4 n-tiles
  for (int task = warp; task < (s.Hp16 / 16) * ngroups; task += kWarps2) {
    const int mt = task / ngroups, n0 = (task % ngroups) * 32;
    float d[4][4];
    warp_tiles<4, false, true>(d, gx + mt * 16, 1, L.gx_s, 0, bm + n0, L.bm_s, 1, bm_lo,
                               2 * ks);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = mt * 16 + g + half * 8, n = n0 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(zp + h * L.zp_s + n) =
            make_float2(d[j][2 * half], d[j][2 * half + 1]);
      }
  }
  cluster.sync();  // every slice's part is in its block's shared memory

  // sum the parts over the cluster, this block taking its share of the rows, and store
  // each (batch, row)'s run of mode columns
  const int rows = (s.H + parts - 1) / parts, h0 = rank * rows;
  sum_parts(cluster, zp, L.zp_s, parts, h0, min(s.H, h0 + rows), 0, n_cols, z, s, o, b0, m0,
            mc);
  cluster.sync();  // no block leaves while another still reads its part
}

// S2 in chunks, where a block's whole slice does not fit (the note above): the slice's
// mode rows kSlice2 at a time, each mixed over chunks of kChansT2 input channels with the
// sums in registers, and the H rows a chunk of kRowsT2 at a time, each summed over the
// cluster before the next (grid z with y: output channels x batch groups).
struct Tiled2 {
  int slices, ks;  // blocks in a cluster (mode-row slices), rows of a slice (x kSlice2)
  int bt, hc, cc;  // batch elements, rows of an H chunk, channels of a weight chunk
  int gx_s, bm_s, zp_s;
  int off_bm, off_w, off_zp;
  int tiles;       // output channels x batch groups
  size_t bytes;
};

Tiled2 tiled2(const Shape& s) {
  Tiled2 L;
  L.slices = min(kCluster2, ceil_div(s.K, kSlice2));
  L.ks = round_up(ceil_div(s.K, L.slices), kSlice2);
  L.bt = min(kBatch2, round_up(s.B, 2));
  L.hc = min(s.Hp16, kRowsT2);
  L.cc = min(s.Cin, kChansT2);
  const int n = 2 * kCols2 * L.bt;
  L.gx_s = stride_cols(L.hc);
  L.bm_s = stride_cols(n);
  L.zp_s = round_up(n, 32) + 8;
  L.off_bm = 2 * kSlice2 * L.gx_s;
  L.off_w = L.off_bm + 2 * (2 * kSlice2 * L.bm_s);
  L.off_zp = L.off_w + 2 * L.cc * kSlice2 * kCols2;
  L.tiles = s.Cout * ceil_div(s.B, L.bt);
  L.bytes = (size_t(L.off_zp) + size_t(L.hc) * L.zp_s) * sizeof(float);
  return L;
}

__global__ void __launch_bounds__(kThreads2) fno2d_mix_inverse_h_tiled(
    const float* spec,  // (m2, B*Cin, K, 2), written by S1 while this grid may be running
    const float* __restrict__ wr, const float* __restrict__ wi,      // (Cin, Cout, K, m2)
    const float* __restrict__ gxre, const float* __restrict__ gxim,  // (K, H)
    float* __restrict__ z,                                           // (B, Cout, H, m2, 2)
    Shape s, Tiled2 L) {
  extern __shared__ __align__(16) float smem[];
  const int tile = folded_tile();
  if (tile >= L.tiles) return;  // the whole cluster: it spans blockIdx.x only
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());  // this block's mode-row slice
  const int n_cols = 2 * kCols2 * L.bt;
  float* gx = smem;             // 2*kSlice2 x gx_s: the row chunk's gx[kk][h] = A3(h, kk)
  float* bm = smem + L.off_bm;  // 2*kSlice2 x bm_s, split: [[Or, Oi], [-Oi, Or]]
  const int bm_lo = 2 * kSlice2 * L.bm_s;
  float* wsr = smem + L.off_w;  // cc x kSlice2 x kCols2: a channel chunk's weights
  float* wsi = wsr + L.cc * kSlice2 * kCols2;
  float* zp = smem + L.off_zp;  // hc x zp_s: this slice's part of the H chunk's Z
  const int m0 = (blockIdx.x / L.slices) * kCols2, o = tile % s.Cout;
  const int b0 = (tile / s.Cout) * L.bt, mc = min(kCols2, s.m2 - m0);
  const int k0 = rank * L.ks, kc = max(0, min(L.ks, s.K - k0));
  const int nb = max(0, min(L.bt, s.B - b0));
  constexpr int kWarps2 = kThreads2 / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kk = threadIdx.x % kSlice2, mm = threadIdx.x / kSlice2;  // one mix item a thread
  static_assert(kThreads2 == kSlice2 * kCols2, "one mix item a thread");
  const float2* spec2 = reinterpret_cast<const float2*>(spec);
  const size_t b_stride = size_t(s.Cin) * s.K;

  launch_dependents();
  wait_prerequisites();  // the spectrum is S1's
  for (int h0 = 0; h0 < s.H; h0 += L.hc) {
    const int hn = min(L.hc, s.H - h0), hp = round_up(hn, 16);
    for (int i = threadIdx.x; i < hp * L.zp_s; i += kThreads2) zp[i] = 0.f;
    for (int r0 = 0; r0 < kc; r0 += kSlice2) {
      const int rn = min(kSlice2, kc - r0), kr = k0 + r0;
      stage_rows(gx, L.gx_s, gxre + size_t(kr) * s.H + h0, s.H, rn, hn, kSlice2, hp);
      stage_rows(gx + kSlice2 * L.gx_s, L.gx_s, gxim + size_t(kr) * s.H + h0, s.H, rn, hn,
                 kSlice2, hp);
      float ar[4] = {0.f, 0.f, 0.f, 0.f}, ai[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c0 = 0; c0 < s.Cin; c0 += L.cc) {
        const int cn = min(L.cc, s.Cin - c0);
        stage_weights(wsr, wsi, kSlice2, wr, wi, s, o, c0, cn, kr, rn, m0, mc);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (kk < rn && mm < mc)
          mix_item(ar, ai, spec2 + (size_t(m0 + mm) * s.B + b0) * b_stride + size_t(c0) * s.K +
                   kr + kk, b_stride, s.K, wsr + kk * kCols2 + mm, wsi + kk * kCols2 + mm,
                   kSlice2 * kCols2, cn, nb);
        __syncthreads();  // the chunk's weights are read
      }
      store_mixed(bm, L.bm_s, bm_lo, kSlice2, kk, mm, 0, L.bt, ar, ai);
      __syncthreads();
      // this row chunk's part of the H chunk: zp += [Gxre^T | Gxim^T] Bm
      const int ngroups = n_cols / 32;
      for (int task = warp; task < (hp / 16) * ngroups; task += kWarps2) {
        const int mt = task / ngroups, n0 = (task % ngroups) * 32;
        float d[4][4];
        warp_tiles<4, false, true>(d, gx + mt * 16, 1, L.gx_s, 0, bm + n0, L.bm_s, 1, bm_lo,
                                   2 * kSlice2);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2* p = reinterpret_cast<float2*>(zp + (mt * 16 + g + half * 8) * L.zp_s + n0 +
                                                  j * 8 + 2 * t);
            const float2 v = *p;
            *p = make_float2(v.x + d[j][2 * half], v.y + d[j][2 * half + 1]);
          }
      }
      __syncthreads();  // gx and bm are free for the next row chunk
    }
    cluster.sync();  // every slice's part of the H chunk is in its block's shared memory
    const int rows = ceil_div(hn, L.slices), lo = rank * rows;
    sum_parts(cluster, zp, L.zp_s, L.slices, lo, min(hn, lo + rows), h0, n_cols, z, s, o, b0,
              m0, mc);
    cluster.sync();  // no block overwrites its part while another still reads it
  }
}

// ---- S3: inverse rDFT along W and the epilogue -------------------------------------------

// S3's plan: a block's output columns (all W, or a W tile as grid z with y) and the columns
// of Z (2*m2 padded to J) it multiplies a pass (all of them, or chunks where the W tile's
// matrix and rows of Z still do not fit; see the note above).
struct Layout3 {
  int wc, jc;             // output columns of a block, Z columns of a pass (x 8)
  int row_tiles, tiles;   // row tiles; of rows x W tiles
  int z_s, gy_s, ys_s;    // row strides of Z's rows, the matrix and the spectral part of y
  int xt_s;               // row stride of x's staged rows, 0 where the epilogue reads L2
  int pk_n;               // pointwise weights staged (Cin, up to kPkStaged)
  int bulk;               // the matrix (and x's rows) by multicast bulk copies
  size_t bytes;
};

size_t smem3(const Shape& s, int wc, int jc) {
  const int wp = round_up(wc, 8);
  return (kBarFloats + size_t(kRows3) * (3 * stride_rows(jc) + round_up(wp, 32) + 8) +
          size_t(jc) * stride_cols(wp) + round_up(min(s.Cin, kPkStaged), 4)) * sizeof(float);
}

// `aligned`: the W matrices and x start on 16-byte boundaries.
Layout3 layout3(const Shape& s, int epilogue, bool aligned) {
  Layout3 L;
  L.wc = s.W, L.jc = s.J;
  if (smem3(s, L.wc, L.jc) > kMaxSmem) {  // W tiles, then chunks of Z's columns
    L.wc = 256;
    while (L.wc > 32 && smem3(s, L.wc, L.jc) > kMaxSmem) L.wc /= 2;
    while (smem3(s, L.wc, L.jc) > kMaxSmem) L.jc = round_up(L.jc / 2, 8);
  }
  const int wp = round_up(L.wc, 8);
  L.row_tiles = ceil_div(s.H, kRows3);
  L.tiles = L.row_tiles * ceil_div(s.W, L.wc);
  L.z_s = stride_rows(L.jc);
  L.gy_s = stride_cols(wp);
  L.ys_s = round_up(wp, 32) + 8;  // 8-byte stores of a half-warp on distinct banks
  L.pk_n = min(s.Cin, kPkStaged);
  L.bytes = smem3(s, L.wc, L.jc);
  // Where the rows of the W matrix and of x are whole 16-byte pieces and one pass takes
  // all of Z's columns, S3 clusters up to 4 output channels' blocks, which take the matrix
  // by multicast bulk copies, and x's rows for the pointwise term too where two blocks
  // still fit on an SM. Elsewhere each block stages the matrix with cp.async and reads x
  // from L2: staging x's rows per block was slower than that (PERF.md section 6).
  L.bulk = s.W % 4 == 0 && aligned && L.jc == s.J;
  const size_t x_tile = size_t(s.Cin) * kRows3 * L.wc * sizeof(float);
  L.xt_s = L.bulk && epilogue >= 1 && L.bytes + x_tile <= kMaxSmem / 2 ? L.wc : 0;
  if (L.xt_s > 0) L.bytes += x_tile;
  return L;
}

template <int kEpilogue>
__global__ void __launch_bounds__(kThreads3) fno2d_inverse_w(
    const float* __restrict__ z,                                     // (B, Cout, H, m2, 2)
    const float* __restrict__ gyre, const float* __restrict__ gyim,  // (m2, W)
    const float* __restrict__ x,                                     // (B, Cin, H, W)
    const float* __restrict__ pk, int pk_si, int pk_so,              // (Cin, Cout) strided
    const float* __restrict__ pb,                                    // (Cout,)
    float* __restrict__ out,                                         // (B, Cout, H, W)
    Shape s, Layout3 L) {
  extern __shared__ __align__(16) float smem[];
  const int tile = folded_tile();
  if (tile >= L.tiles) return;  // the whole cluster: it spans blockIdx.x only
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* zs = smem + kBarFloats;     // kRows3 x z_s, split: A4(r, 2m + re/im), this pass's
  const int zs_lo = kRows3 * L.z_s;
  float* zraw = zs + 2 * zs_lo;      // kRows3 x z_s: the rows of Z as they come in
  float* gy = zraw + zs_lo;          // jc x gy_s: B4(2m + re/im, w), this pass's rows
  float* pks = gy + L.jc * L.gy_s;   // pk_n: this output channel's pointwise column
  float* ys = pks + round_up(L.pk_n, 4);  // kRows3 x ys_s: the spectral part of y
  float* xt = ys + kRows3 * L.ys_s;  // Cin x kRows3 x xt_s: x's rows, where xt_s > 0
  const int bo = blockIdx.x, b = bo / s.Cout, o = bo % s.Cout;
  const int h0 = (tile % L.row_tiles) * kRows3, w0 = (tile / L.row_tiles) * L.wc;
  const int wn = min(L.wc, s.W - w0), wp = round_up(wn, 8);  // this block's columns
  constexpr int kWarps3 = kThreads3 / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // The W matrix, and the rows of x for the pointwise term, are the same for every
  // output channel: blocks of consecutive channels form a cluster where the rows allow,
  // and each brings in a share of them, multicast to all
  const size_t hw = size_t(s.H) * s.W;
  const int rows = min(kRows3, s.H - h0);
  const bool x_tile = kEpilogue >= 1 && L.xt_s > 0;
  const float* xb = x + size_t(b) * s.Cin * hw + size_t(h0) * s.W + w0;
  // the matrix's rows [j0, j0 + jc) and Z's columns [j0, j0 + jc) (j = 2m + re/im), by
  // cp.async, and zeros in the matrix's rows past 2*m2
  auto stage_matrix = [&](int j0) {
    const int modes = min(L.jc, 2 * s.m2 - j0) / 2;
    stage_rows(gy, 2 * L.gy_s, gyre + size_t(j0 / 2) * s.W + w0, s.W, modes, wn, modes, wp);
    stage_rows(gy + L.gy_s, 2 * L.gy_s, gyim + size_t(j0 / 2) * s.W + w0, s.W, modes, wn, modes,
               wp);
  };
  auto stage_z = [&](int j0) {
    const int n = min(L.jc, 2 * s.m2 - j0);
    stage_rows(zraw, L.z_s, z + (size_t(bo) * s.H + h0) * 2 * s.m2 + j0, 2 * s.m2, rows, n,
               kRows3, L.jc);
    cp_async_commit();
    for (int i = threadIdx.x; i < (L.jc - n) * L.gy_s; i += kThreads3) gy[n * L.gy_s + i] = 0.f;
  };
  if (L.bulk) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = int(cluster.block_rank()), csize = int(cluster.num_blocks());
    if (threadIdx.x == 0) mbar_init(bar);
    cluster.sync();  // every block's barrier is ready before any copy lands
    if (threadIdx.x == 0)
      mbar_expect(bar, (2u * s.m2 + (x_tile ? unsigned(s.Cin) * rows : 0u)) * wn * 4);
    multicast_rows(gy, 2 * L.gy_s, gyre + w0, s.W, s.m2, wn, bar, rank, csize);
    multicast_rows(gy + L.gy_s, 2 * L.gy_s, gyim + w0, s.W, s.m2, wn, bar, rank, csize);
    zero_pad(gy, 2 * L.gy_s, s.m2, wn, s.m2, wp);
    zero_pad(gy + L.gy_s, 2 * L.gy_s, s.m2, wn, s.m2, wp);
    if (x_tile)
      for (int c = 0; c < s.Cin; ++c)
        multicast_rows(xt + c * kRows3 * L.xt_s, L.xt_s, xb + c * hw, s.W, rows, wn, bar, rank,
                       csize);
  } else {
    stage_matrix(0);
  }
  wait_prerequisites();  // Z is S2's
  stage_z(0);
  if (kEpilogue >= 1)
    for (int c = threadIdx.x; c < L.pk_n; c += kThreads3) pks[c] = pk[c * pk_si + o * pk_so];

  for (int j0 = 0;;) {  // one pass, unless Z's columns come in chunks
    cp_async_wait<0>();
    if (L.bulk) mbar_wait(bar, 0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows3 * L.jc; i += kThreads3) {  // every warp reads
      const int r = i / L.jc, c = i % L.jc;                          // all of them: split once
      store_split(zs + r * L.z_s + c, zs_lo, zraw[r * L.z_s + c]);
    }
    __syncthreads();

    for (int n0 = warp * 2; n0 < wp / 8; n0 += 2 * kWarps3) {  // 2 n-tiles a warp
      float d[2][4];
      warp_tiles<2, true, false>(d, zs, L.z_s, 1, zs_lo, gy + n0 * 8, L.gy_s, 1, 0, L.jc);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2* p = reinterpret_cast<float2*>(ys + (g + half * 8) * L.ys_s + (n0 + j) * 8 +
                                                2 * t);
          const float2 v = j0 == 0 ? make_float2(0.f, 0.f) : *p;
          *p = make_float2(v.x + d[j][2 * half], v.y + d[j][2 * half + 1]);
        }
    }
    j0 += L.jc;
    if (j0 >= 2 * s.m2) break;
    __syncthreads();  // every warp is done with this pass's rows
    stage_matrix(j0);
    stage_z(j0);
  }
  __syncthreads();

  // the epilogue over the tile, 4 columns a thread where the rows of x and y are 16-byte
  // aligned; x's rows come from shared memory where they were staged, else from L2 with
  // the loads of several input channels in flight at once
  const bool quads = s.W % 4 == 0 && (x_tile || (reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                     (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int per_row = quads ? wn / 4 : wn;
  const float bias = kEpilogue >= 1 ? __ldg(pb + o) : 0.f;
  float* ob = out + (size_t(b) * s.Cout + o) * hw + size_t(h0) * s.W + w0;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads3) {
    const int r = i / per_row, w = quads ? (i % per_row) * 4 : i % per_row;
    const int n = quads ? 4 : 1;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? ys[r * L.ys_s + w + e] : 0.f;
    if (x_tile) {
      const float* xp = xt + r * L.xt_s + w;
      if (quads) {
#pragma unroll 4
        for (int c = 0; c < s.Cin; ++c) {
          const float4 xv = *reinterpret_cast<const float4*>(xp + c * kRows3 * L.xt_s);
          v[0] = fmaf(xv.x, pks[c], v[0]);
          v[1] = fmaf(xv.y, pks[c], v[1]);
          v[2] = fmaf(xv.z, pks[c], v[2]);
          v[3] = fmaf(xv.w, pks[c], v[3]);
        }
      } else {
        for (int c = 0; c < s.Cin; ++c) v[0] = fmaf(xp[c * kRows3 * L.xt_s], pks[c], v[0]);
      }
    } else if (kEpilogue >= 1) {
      const float* xp = xb + size_t(r) * s.W + w;
      if (quads) {
#pragma unroll 8
        for (int c = 0; c < L.pk_n; ++c) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(xp + c * hw));
          v[0] = fmaf(xv.x, pks[c], v[0]);
          v[1] = fmaf(xv.y, pks[c], v[1]);
          v[2] = fmaf(xv.z, pks[c], v[2]);
          v[3] = fmaf(xv.w, pks[c], v[3]);
        }
        for (int c = L.pk_n; c < s.Cin; ++c) {  // channels past those staged
          const float4 xv = __ldg(reinterpret_cast<const float4*>(xp + c * hw));
          const float u = __ldg(pk + size_t(c) * pk_si + size_t(o) * pk_so);
          v[0] = fmaf(xv.x, u, v[0]);
          v[1] = fmaf(xv.y, u, v[1]);
          v[2] = fmaf(xv.z, u, v[2]);
          v[3] = fmaf(xv.w, u, v[3]);
        }
      } else {
#pragma unroll 8
        for (int c = 0; c < L.pk_n; ++c) v[0] = fmaf(__ldg(xp + c * hw), pks[c], v[0]);
        for (int c = L.pk_n; c < s.Cin; ++c)
          v[0] = fmaf(__ldg(xp + c * hw), __ldg(pk + size_t(c) * pk_si + size_t(o) * pk_so),
                      v[0]);
      }
    }
    if (kEpilogue >= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += bias;
    if (kEpilogue == 2)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = 0.5f * v[e] * (1.f + erff(v[e] * 0.70710678118654752f));
    float* op = ob + size_t(r) * s.W + w;
    if (quads)
      *reinterpret_cast<float4*>(op) = make_float4(v[0], v[1], v[2], v[3]);
    else
      op[0] = v[0];
  }
}

// S3 grouped, where the layout above would leave SMs idle, tile W, or read x for the
// pointwise term from L2 one column a thread or over many input channels (the note
// above): a block takes kOut3 consecutive output channels' rows of one row tile and W
// tile. It stages the W matrix's columns of its tile once for them all and, for the
// pointwise term, x's rows of the tile in chunks of input channels (double-buffered by
// cp.async, rows padded to whole 16-byte pieces), read 4 columns a thread and summed
// into each of the block's output channels from one staging.
struct Group3 {
  int oc, groups;            // output channels of a block; blocks of a batch element
  int wc, row_tiles, tiles;  // W tile; row tiles; row tiles x W tiles
  int cc, chunks;            // input channels of an x chunk (0: no pointwise term); chunks
  int z_s, gy_s, ys_s, xs_s;
  int off_zs, off_ys, off_xs, off_pk;
  size_t bytes;
};

// Shared memory of S3 grouped, in floats, at W tile wc and x chunks of cc channels.
size_t smem_g3(const Shape& s, int wc, int cc) {
  const size_t wp = round_up(wc, 8), oc = min(s.Cout, kOut3);
  return size_t(s.J) * stride_cols(int(wp)) + 2 * oc * kRows3 * stride_rows(s.J) +
         oc * kRows3 * (round_up(int(wp), 32) + 8) + size_t(2) * cc * (kRows3 * wp + kOut3);
}

// The grouped layout: W tiles of up to 256 columns (all W where it has no more), halved
// down to kTileG3 while the grid would have fewer than two blocks an SM or two blocks
// would not fit in an SM's shared memory; then x chunks as large as the shared memory
// left allows (all of it where one block an SM holds the grid). bytes is 0 where even
// kTileG3 columns do not fit: S3 then takes the layout above.
Group3 group3(const Shape& s, int epilogue, int sms) {
  Group3 L;
  L.oc = min(s.Cout, kOut3);
  L.groups = ceil_div(s.Cout, L.oc);
  L.row_tiles = ceil_div(s.H, kRows3);
  const long base = long(s.B) * L.groups * L.row_tiles;
  const int c1 = epilogue >= 1 ? 1 : 0;
  const size_t half = kMaxSmem / 2 / sizeof(float), most = kMaxSmem / sizeof(float);
  int wc = min(s.W, 256);
  while (wc > kTileG3 && (base * ceil_div(s.W, wc) < 2L * sms || smem_g3(s, wc, c1) > half)) {
    int p = kTileG3;  // the largest power of two below wc, at least kTileG3
    while (2 * p < wc) p *= 2;
    wc = p;
  }
  const long blocks = base * ceil_div(s.W, wc);
  const size_t fixed = smem_g3(s, wc, 0), per_channel = smem_g3(s, wc, 1) - fixed;
  const size_t budget = blocks <= sms || smem_g3(s, wc, c1) > half ? most : half;
  size_t cc = budget > fixed ? (budget - fixed) / per_channel : 0;
  if (cc < 1) cc = 1;
  if (cc > size_t(s.Cin)) cc = size_t(s.Cin);
  L.cc = c1 * int(cc);
  L.wc = wc;
  L.tiles = L.row_tiles * ceil_div(s.W, wc);
  L.chunks = L.cc > 0 ? ceil_div(s.Cin, L.cc) : 0;
  const int wp = round_up(wc, 8);
  L.z_s = stride_rows(s.J);
  L.gy_s = stride_cols(wp);
  L.ys_s = round_up(wp, 32) + 8;
  L.xs_s = wp;
  const size_t floats = smem_g3(s, wc, L.cc);
  if (floats > most) {
    L.bytes = 0;
    return L;
  }
  L.off_zs = s.J * L.gy_s;
  L.off_ys = L.off_zs + 2 * L.oc * kRows3 * L.z_s;
  L.off_xs = L.off_ys + L.oc * kRows3 * L.ys_s;
  L.off_pk = L.off_xs + 2 * L.cc * kRows3 * L.xs_s;
  L.bytes = floats * sizeof(float);
  return L;
}

template <int kEpilogue>
__global__ void __launch_bounds__(kThreads3) fno2d_inverse_w_grouped(
    const float* __restrict__ z,                                     // (B, Cout, H, m2, 2)
    const float* __restrict__ gyre, const float* __restrict__ gyim,  // (m2, W)
    const float* __restrict__ x,                                     // (B, Cin, H, W)
    const float* __restrict__ pk, int pk_si, int pk_so,              // (Cin, Cout) strided
    const float* __restrict__ pb,                                    // (Cout,)
    float* __restrict__ out,                                         // (B, Cout, H, W)
    Shape s, Group3 L) {
  extern __shared__ __align__(16) float smem[];
  const int tile = folded_tile();
  if (tile >= L.tiles) return;
  float* gy = smem;             // J x gy_s: B4(2m + re/im, w) of the W tile
  float* zs = smem + L.off_zs;  // oc x kRows3 x z_s, split: the channels' rows of Z
  const int zs_lo = L.oc * kRows3 * L.z_s;
  float* ys = smem + L.off_ys;  // oc x kRows3 x ys_s: the channels' rows of y
  float* xs = smem + L.off_xs;  // 2 x cc x kRows3 x xs_s: x's rows, a chunk a buffer
  float* pks = smem + L.off_pk;  // 2 x cc x kOut3: the chunk's pointwise weights
  static_assert(kOut3 == 4, "a channel's pointwise weights are one float4");
  const int b = blockIdx.x / L.groups, o0 = (blockIdx.x % L.groups) * L.oc;
  const int on = min(L.oc, s.Cout - o0);
  const int h0 = (tile % L.row_tiles) * kRows3, w0 = (tile / L.row_tiles) * L.wc;
  const int rows = min(kRows3, s.H - h0), wn = min(L.wc, s.W - w0), wp = round_up(wn, 8);
  constexpr int kWarps3 = kThreads3 / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t hw = size_t(s.H) * s.W;
  const bool vec_x = s.W % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // x's rows [h0, h0 + rows) of chunk i's input channels, columns [w0, w0 + wn) and zeros
  // up to wp, into buffer i % 2, as pieces of 4 floats where x's rows are whole 16-byte
  // pieces, else of 1; each thread steps through its pieces without a division. Then the
  // chunk's pointwise weights, kOut3 a channel (zero past the block's channels).
  const int per = vec_x ? 4 : 1, pieces = wp / per;
  const int step_rows = kThreads3 / pieces, step_q = kThreads3 % pieces;
  auto stage_x = [&](int i) {
    const int c0 = i * L.cc, cn = min(L.cc, s.Cin - c0), n_rows = cn * kRows3;
    float* dst = xs + (i & 1) * L.cc * kRows3 * L.xs_s;
    const float* src0 = x + (size_t(b) * s.Cin + c0) * hw + size_t(h0) * s.W + w0;
    int row = threadIdx.x / pieces, q = threadIdx.x - row * pieces;
    while (row < n_rows) {
      const int r = row % kRows3, w = q * per;
      if (r < rows) {
        float* d = dst + row * L.xs_s + w;
        const float* src = src0 + size_t(row / kRows3) * hw + size_t(r) * s.W + w;
        if (vec_x) {
          const int n = min(4, wn - w);
          if (n > 0)
            cp_async16(d, src, 4 * n);  // zero-fills past n floats
          else
            *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if (w < wn) {
          cp_async4(d, src);
        } else {
          *d = 0.f;
        }
      }
      row += step_rows, q += step_q;
      if (q >= pieces) q -= pieces, ++row;
    }
    float* pkd = pks + (i & 1) * L.cc * kOut3;
    for (int e = threadIdx.x; e < cn * kOut3; e += kThreads3) {
      const int c = e / kOut3, j = e % kOut3;
      if (j < on)
        cp_async4(pkd + e, pk + size_t(c0 + c) * pk_si + size_t(o0 + j) * pk_so);
      else
        pkd[e] = 0.f;
    }
    cp_async_commit();
  };

  // the next kernel (a next layer's tiled S1) may stage its constants from here on: every
  // kernel of this source reads the output of the kernel before only after its wait
  launch_dependents();
  // the W matrix's columns of the tile (rows j = 2m + re/im, zero past 2*m2) and the first
  // x chunk come in while S2 finishes
  stage_rows_t(gy, 2 * L.gy_s, gyre + w0, s.W, s.m2, wn, s.m2, wp);
  stage_rows_t(gy + L.gy_s, 2 * L.gy_s, gyim + w0, s.W, s.m2, wn, s.m2, wp);
  for (int i = threadIdx.x; i < (s.J - 2 * s.m2) * L.gy_s; i += kThreads3)
    gy[2 * s.m2 * L.gy_s + i] = 0.f;
  cp_async_commit();
  if (kEpilogue >= 1) stage_x(0);
  wait_prerequisites();  // Z is S2's
  for (int j = 0; j < on; ++j)
    stage_rows_t(zs + j * kRows3 * L.z_s, L.z_s,
               z + ((size_t(b) * s.Cout + o0 + j) * s.H + h0) * 2 * s.m2, 2 * s.m2, rows,
               2 * s.m2, kRows3, s.J);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int r = warp; r < on * kRows3; r += kWarps3)  // every warp reads every row of Z:
    for (int c = lane; c < s.J; c += 32) {           // split each once, in place
      float* p = zs + r * L.z_s + c;
      store_split(p, zs_lo, *p);
    }
  __syncthreads();

  // the spectral part of each channel's rows, y_j = Z_j [Gyre; Gyim], kNT3 n-tiles a task
  constexpr int kNT3 = 2;
  const int groups_n = ceil_div(wp, 8 * kNT3);
  for (int task = warp; task < on * groups_n; task += kWarps3) {
    const int j = task / groups_n, n0 = (task % groups_n) * kNT3;
    float d[kNT3][4];
    warp_tiles<kNT3, true, false>(d, zs + j * kRows3 * L.z_s, L.z_s, 1, zs_lo, gy + n0 * 8,
                                  L.gy_s, 1, 0, s.J);
    float* yj = ys + j * kRows3 * L.ys_s;
#pragma unroll
    for (int jj = 0; jj < kNT3; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(yj + (g + half * 8) * L.ys_s + (n0 + jj) * 8 + 2 * t) =
            make_float2(d[jj][2 * half], d[jj][2 * half + 1]);
  }
  __syncthreads();

  // the pointwise term, chunk by chunk: each thread adds its quads (a row's 4 columns) of
  // every input channel of the chunk into each output channel's row of y
  const int qr = wp / 4;
  if (kEpilogue >= 1)
    for (int i = 0; i < L.chunks; ++i) {
      if (i + 1 < L.chunks) {
        stage_x(i + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int cn = min(L.cc, s.Cin - i * L.cc);
      const float* xb = xs + (i & 1) * L.cc * kRows3 * L.xs_s;
      const float4* pkb = reinterpret_cast<const float4*>(pks + (i & 1) * L.cc * kOut3);
      for (int q = threadIdx.x; q < rows * qr; q += kThreads3) {
        const int r = q / qr, w = (q - r * qr) * 4;
        float4 a[kOut3];
#pragma unroll
        for (int j = 0; j < kOut3; ++j)
          a[j] = j < on ? *reinterpret_cast<const float4*>(ys + (j * kRows3 + r) * L.ys_s + w)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int c = 0; c < cn; ++c) {
          const float4 xv = *reinterpret_cast<const float4*>(xb + (c * kRows3 + r) * L.xs_s + w);
          const float4 u4 = pkb[c];
          const float u[kOut3] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int j = 0; j < kOut3; ++j) {
            a[j].x = fmaf(xv.x, u[j], a[j].x);
            a[j].y = fmaf(xv.y, u[j], a[j].y);
            a[j].z = fmaf(xv.z, u[j], a[j].z);
            a[j].w = fmaf(xv.w, u[j], a[j].w);
          }
        }
#pragma unroll
        for (int j = 0; j < kOut3; ++j)
          if (j < on) *reinterpret_cast<float4*>(ys + (j * kRows3 + r) * L.ys_s + w) = a[j];
      }
      __syncthreads();  // buffer i % 2 is free for chunk i + 2
    }

  // bias, gelu and the stores, 4 columns a thread (as whole float4 where rows allow)
  const bool vec_out = s.W % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int q = threadIdx.x; q < rows * qr; q += kThreads3) {
    const int r = q / qr, w = (q - r * qr) * 4;
    if (w >= wn) continue;
    for (int j = 0; j < on; ++j) {
      const float4 v4 = *reinterpret_cast<const float4*>(ys + (j * kRows3 + r) * L.ys_s + w);
      float v[4] = {v4.x, v4.y, v4.z, v4.w};
      if (kEpilogue >= 1) {
        const float bias = __ldg(pb + o0 + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] += bias;
      }
      if (kEpilogue == 2)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = 0.5f * v[e] * (1.f + erff(v[e] * 0.70710678118654752f));
      float* op = out + ((size_t(b) * s.Cout + o0 + j) * s.H + h0 + r) * s.W + w0 + w;
      if (vec_out) {
        *reinterpret_cast<float4*>(op) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int e = 0; e < min(4, wn - w); ++e) op[e] = v[e];
      }
    }
  }
}

template <int kEpilogue>
cudaError_t launch_inverse_w_grouped(int device, cudaStream_t stream, const float* z,
                                     const float* gyre, const float* gyim, const float* x,
                                     const float* pk, int pk_si, int pk_so, const float* pb,
                                     float* out, const Shape& s, const Group3& L) {
  static bool raised[kMaxDevices] = {};
  cudaError_t err = allow_smem(fno2d_inverse_w_grouped<kEpilogue>, L.bytes, device, raised);
  if (err != cudaSuccess) return err;
  return launch_clusters(fno2d_inverse_w_grouped<kEpilogue>,
                         folded(unsigned(s.B) * L.groups, L.tiles), kThreads3, L.bytes, dim3(1),
                         stream, z, gyre, gyim, x, pk, pk_si, pk_so, pb, out, s, L);
}

template <int kEpilogue>
cudaError_t launch_inverse_w(dim3 grid, int csize, int device, cudaStream_t stream,
                             const float* z, const float* gyre, const float* gyim,
                             const float* x, const float* pk, int pk_si, int pk_so,
                             const float* pb, float* out, const Shape& s, const Layout3& L) {
  static bool raised[kMaxDevices] = {};
  cudaError_t err = allow_smem(fno2d_inverse_w<kEpilogue>, L.bytes, device, raised);
  if (err != cudaSuccess) return err;
  return launch_clusters(fno2d_inverse_w<kEpilogue>, grid, kThreads3, L.bytes, dim3(csize),
                         stream, z, gyre, gyim, x, pk, pk_si, pk_so, pb, out, s, L);
}

// The three launches of one layer; `device` is current. Each stage takes its whole
// operands where they fit in a block and its grid in y and z, else its tiled layout.
cudaError_t launch_layer(const float* x, const float* fyre, const float* fyim,
                         const float* fxre, const float* fxim, const float* gxre,
                         const float* gxim, const float* gyre, const float* gyim,
                         const float* wr, const float* wi, const float* pk, int pk_si,
                         int pk_so, const float* pb, float* spec, float* z, float* out, int B,
                         int Cin, int Cout, int H, int W, int m1, int m2, int epilogue,
                         int device, cudaStream_t stream) {
  Shape s;
  s.B = B, s.Cin = Cin, s.Cout = Cout, s.H = H, s.W = W, s.K = 2 * m1, s.m2 = m2;
  s.Hp8 = round_up(H, 8), s.Hp16 = round_up(H, 16), s.Wp8 = round_up(W, 8);
  s.Kp16 = round_up(s.K, 16), s.J = round_up(2 * m2, 8);
  auto aligned16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  static int sms[kMaxDevices] = {};
  cudaError_t err;
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }

  static bool raised1[kMaxDevices] = {}, raised1t[kMaxDevices] = {};
  const Layout1 L1 = layout1(s);
  if (L1.bytes <= kMaxSmem && ceil_div(m2, kCols1) <= kMaxGridYZ) {
    err = allow_smem(fno2d_forward_transform, L1.bytes, device, raised1);
    if (err != cudaSuccess) return err;
    const dim3 grid1(B * Cin, ceil_div(m2, kCols1));
    fno2d_forward_transform<<<grid1, kThreads1, L1.bytes, stream>>>(x, fyre, fyim, fxre, fxim,
                                                                   spec, s, L1);
    err = cudaGetLastError();
  } else {
    Tiled1 T1, wide;
    err = fit_tiled1(s, 0, sms[device], device, raised1t, T1);
    if (err != cudaSuccess) return err;
    // where the largest cluster still leaves a block more than one chunk, wider W chunks
    // that give each block one, if they keep the cluster and fit
    const int h_chunks = ceil_div(H, T1.hc);
    if (T1.cs == kCluster1 && T1.chunks > kCluster1 && h_chunks <= kCluster1 &&
        tiled1(s, round_up(ceil_div(W, kCluster1 / h_chunks), 8)).bytes <= kMaxSmem) {
      err = fit_tiled1(s, round_up(ceil_div(W, kCluster1 / h_chunks), 8), sms[device], device,
                       raised1t, wide);
      if (err != cudaSuccess) return err;
      if (wide.cs == kCluster1 && wide.chunks <= kCluster1) T1 = wide;
    }
    // a programmatic dependent of the kernel before (whose output it reads only after
    // wait_prerequisites) where its grid takes one block an SM at most: where it takes
    // more, blocks placed early crowd the SMs that the kernel before left room on, and the
    // stage ran slower than launched plainly (PERF.md section 6)
    const bool early = long(B) * Cin * T1.tiles * T1.cs <= sms[device];
    err = launch_cluster_grid(fno2d_forward_transform_tiled,
                              folded(unsigned(B) * Cin * T1.cs, T1.tiles), kThreads1, T1.bytes,
                              dim3(T1.cs), early, stream, x, fyre, fyim, fxre, fxim, spec, s,
                              T1);
  }
  if (err != cudaSuccess) return err;

  static bool raised2[kMaxDevices] = {}, raised2s[kMaxDevices] = {}, raised2t[kMaxDevices] = {};
  const Layout2 L2 = layout2(s, 1);
  const int col_tiles2 = ceil_div(m2, kCols2);
  const bool grid2_fits = Cout <= kMaxGridYZ && ceil_div(B, L2.bt) <= kMaxGridYZ;
  // past kChansS2 input channels, each slice's channels split among the cluster's blocks
  // (as many as the cluster has room for, a power of two)
  int cranks = 1;
  while (2 * cranks * L2.slices <= kCluster2) cranks *= 2;
  const Layout2 S2 = layout2(s, cranks);
  if (Cin > kChansS2 && S2.bytes <= kMaxSmem && grid2_fits) {
    err = allow_smem(fno2d_mix_inverse_h<true>, S2.bytes, device, raised2s);
    if (err != cudaSuccess) return err;
    const int parts = S2.slices * S2.cranks;
    const dim3 grid2(parts * col_tiles2, Cout, ceil_div(B, S2.bt));
    err = launch_clusters(fno2d_mix_inverse_h<true>, grid2, kThreads2, S2.bytes, dim3(parts),
                          stream, spec, wr, wi, gxre, gxim, z, s, S2);
  } else if (L2.bytes <= kMaxSmem && grid2_fits &&
             (2 * L2.bytes <= kMaxSmem || 2 * tiled2(s).bytes > kMaxSmem)) {
    err = allow_smem(fno2d_mix_inverse_h<false>, L2.bytes, device, raised2);
    if (err != cudaSuccess) return err;
    const dim3 grid2(L2.slices * col_tiles2, Cout, ceil_div(B, L2.bt));
    err = launch_clusters(fno2d_mix_inverse_h<false>, grid2, kThreads2, L2.bytes,
                          dim3(L2.slices), stream, spec, wr, wi, gxre, gxim, z, s, L2);
  } else {
    const Tiled2 T2 = tiled2(s);
    err = allow_smem(fno2d_mix_inverse_h_tiled, T2.bytes, device, raised2t);
    if (err != cudaSuccess) return err;
    // launched plainly: as a programmatic dependent of S1 it ran up to a fifth slower
    // (PERF.md section 6)
    err = launch_cluster_grid(fno2d_mix_inverse_h_tiled,
                              folded(T2.slices * col_tiles2, T2.tiles), kThreads2, T2.bytes,
                              dim3(T2.slices), false, stream, spec, wr, wi, gxre, gxim, z, s, T2);
  }
  if (err != cudaSuccess) return err;

  const Layout3 L3 =
      layout3(s, epilogue, aligned16(gyre) && aligned16(gyim) && aligned16(x));
  // S3 grouped where the layout above would read x's rows from L2 one column a thread or
  // over more than kChansL2 input channels, would leave three in four SMs idle, or tiles W
  // (the models' shapes take none of these: the note above)
  const bool l2_epilogue = epilogue >= 1 && L3.xt_s == 0 &&
                           (W % 4 != 0 || !aligned16(x) || !aligned16(out) || Cin > kChansL2);
  if (l2_epilogue || long(B) * Cout * L3.tiles < sms[device] / 4 || L3.wc < W) {
    const Group3 G3 = group3(s, epilogue, sms[device]);
    if (G3.bytes > 0) {
#define FNO2D_LAUNCH(E)                                                                   \
  launch_inverse_w_grouped<E>(device, stream, z, gyre, gyim, x, pk, pk_si, pk_so, pb, out, s, \
                              G3)
      switch (epilogue) {
        case 0: return FNO2D_LAUNCH(0);
        case 1: return FNO2D_LAUNCH(1);
        default: return FNO2D_LAUNCH(2);
      }
#undef FNO2D_LAUNCH
    }
  }
  const int csize3 = !L3.bulk ? 1 : Cout % 4 == 0 ? 4 : Cout % 2 == 0 ? 2 : 1;
  const dim3 grid3 = folded(B * Cout, L3.tiles);
#define FNO2D_LAUNCH(E)                                                                      \
  launch_inverse_w<E>(grid3, csize3, device, stream, z, gyre, gyim, x, pk, pk_si, pk_so, pb, \
                      out, s, L3)
  switch (epilogue) {
    case 0: return FNO2D_LAUNCH(0);
    case 1: return FNO2D_LAUNCH(1);
    default: return FNO2D_LAUNCH(2);
  }
#undef FNO2D_LAUNCH
}

}  // namespace

extern "C" {

// One FNO2d layer. `epilogue`: 0 spectral conv only (spectral_conv2d), 1 adds the
// pointwise term and bias, 2 also applies the exact gelu (fno2d_layer). `spec` and `z`
// are caller-allocated scratch of 2 * B * Cin * 2*m1 * m2 and 2 * B * Cout * H * m2
// floats. The three launches go to `device` on `stream`; the calling thread's current
// device is the same on return. Returns the first CUDA error code (0 on success; the
// text is blindno_error_string's).
int fno2d_layer_forward(const float* x, const float* fyre, const float* fyim,
                        const float* fxre, const float* fxim, const float* gxre,
                        const float* gxim, const float* gyre, const float* gyim,
                        const float* wr, const float* wi, const float* pk, int pk_si,
                        int pk_so, const float* pb, float* spec, float* z, float* out, int B,
                        int Cin, int Cout, int H, int W, int m1, int m2, int epilogue,
                        int device, void* stream) {
  if (epilogue < 0 || epilogue > 2) return cudaErrorInvalidValue;
  return blindno::on_device(device, [&] {
    return launch_layer(x, fyre, fyim, fxre, fxim, gxre, gxim, gyre, gyim, wr, wi, pk, pk_si,
                        pk_so, pb, spec, z, out, B, Cin, Cout, H, W, m1, m2, epilogue, device,
                        static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
