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
//
// Limits: S1 holds one x plane and the H matrix in shared memory (or, where both do not
// fit, the matrix in the plane's place once the rDFT is done), S2 a slice of the H matrix
// and its partial product, S3 its rows of Z and the W matrix (and x's rows where two
// blocks still fit on an SM; else the epilogue reads x from L2). A shape whose stage
// needs more than the 227 KB a block may use is refused with cudaErrorInvalidValue
// before any launch. That takes square grids up to 144 x 144 with every mode kept
// (2*m1 = H, m2 = W/2 + 1) and up to 176 x 176 at 32 x 32 modes, and up to 175 input
// channels at the main shape (S2 holds its slice of every channel's weights): the
// models' grids (76 and 100) and widths (4-30) with room to spare. The two-stage kernel
// this replaces took grids up to 232 x 232, thin ones such as 16 x 3600, and any number
// of channels; taking those again needs S1 and S3 to tile the plane, the matrices and
// B2, and S2 the channels (ROADMAP.md).

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

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
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
  const int row4 = s.K / 2;
  float4* spec4 = reinterpret_cast<float4*>(spec);
  const float4* st4 = reinterpret_cast<const float4*>(st);
  for (int i = threadIdx.x; i < mc * row4; i += kThreads1) {
    const int c = i / row4, r = i % row4;
    spec4[(size_t(m0 + c) * s.B * s.Cin + plane) * row4 + r] = st4[c * row4 + r];
  }
}

// ---- S2: mode mix and inverse +-DFT along H, one cluster per column tile ------------------

struct Layout2 {
  int slices, ks;  // blocks in a cluster (mode-row slices), rows of a slice
  int bt;          // batch elements per block (even: 16*bt columns, 4 n-tiles a warp)
  int gx_s, bm_s, zp_s;
  int off_bm, off_w, off_zp;
  size_t bytes;
};

Layout2 layout2(const Shape& s) {
  Layout2 L;
  L.slices = min(kCluster2, (s.K + kSlice2 - 1) / kSlice2);
  L.ks = round_up((s.K + L.slices - 1) / L.slices, 8);
  L.bt = min(kBatch2, round_up(s.B, 2));
  const int n = 2 * kCols2 * L.bt;  // (batch, mode column, re/im)
  L.gx_s = stride_cols(s.Hp16);
  L.bm_s = stride_cols(n);
  L.zp_s = round_up(n, 32) + 8;     // 8-byte stores of a half-warp on distinct banks
  L.off_bm = 2 * L.ks * L.gx_s;
  L.off_w = L.off_bm + 2 * (2 * L.ks * L.bm_s);
  L.off_zp = L.off_w + 2 * s.Cin * L.ks * kCols2;
  L.bytes = (size_t(L.off_zp) + size_t(s.Hp16) * L.zp_s) * sizeof(float);
  return L;
}

__global__ void __launch_bounds__(kThreads2) fno2d_mix_inverse_h(
    const float* spec,  // (m2, B*Cin, K, 2), written by S1 while this grid may be running
    const float* __restrict__ wr, const float* __restrict__ wi,      // (Cin, Cout, K, m2)
    const float* __restrict__ gxre, const float* __restrict__ gxim,  // (K, H)
    float* __restrict__ z,                                           // (B, Cout, H, m2, 2)
    Shape s, Layout2 L) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());  // this block's mode-row slice
  const int ks = L.ks, n_cols = 2 * kCols2 * L.bt;
  float* gx = smem;                            // 2*ks x gx_s: gx[kk][h] = A3(h, kk)
  float* bm = smem + L.off_bm;                 // 2*ks x bm_s, split: [[Or, Oi], [-Oi, Or]]
  const int bm_lo = 2 * ks * L.bm_s;
  float* wsr = smem + L.off_w;                 // Cin x ks x kCols2: the slice's weights
  float* wsi = wsr + s.Cin * ks * kCols2;
  float* zp = smem + L.off_zp;                 // Hp16 x zp_s: this slice's part of Z
  const int m0 = (blockIdx.x / L.slices) * kCols2, o = blockIdx.y, b0 = blockIdx.z * L.bt;
  const int k0 = rank * ks, kc = max(0, min(ks, s.K - k0)), mc = min(kCols2, s.m2 - m0);
  constexpr int kWarps2 = kThreads2 / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  stage_rows(gx, L.gx_s, gxre + size_t(k0) * s.H, s.H, kc, s.H, ks, s.Hp16);
  stage_rows(gx + ks * L.gx_s, L.gx_s, gxim + size_t(k0) * s.H, s.H, kc, s.H, ks, s.Hp16);
  // the weights: rows k0.. of each (K, m2) plane (c, o), 8 columns, as 16-byte pieces
  // where the rows allow
  const bool wvec = s.m2 % 4 == 0 && ((reinterpret_cast<uintptr_t>(wr) |
                                       reinterpret_cast<uintptr_t>(wi)) & 15) == 0;
  for (int i = threadIdx.x; i < s.Cin * ks * 2; i += kThreads2) {
    const int c = i / (2 * ks), k = (i / 2) % ks, c0 = (i % 2) * 4;
    const int n = k < kc ? min(4, mc - c0) : 0;
    const size_t q = ((size_t(c) * s.Cout + o) * s.K + k0 + k) * s.m2 + m0 + c0;
    float* dr = wsr + (c * ks + k) * kCols2 + c0;
    float* di = wsi + (c * ks + k) * kCols2 + c0;
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
  cp_async_commit();
  launch_dependents();
  wait_prerequisites();  // the spectrum is S1's
  cp_async_wait<0>();
  __syncthreads();

  // the per-mode complex mix on the f32 cores: an item is one (mode row, mode column,
  // group of 4 batch elements); lanes run along the rows, which are contiguous in the
  // spectrum, and the spectrum loads of several input channels are in flight at once.
  // The spectrum is read through L2 (ld.global.cg), not the read-only path: S1 wrote it
  // during this grid's lifetime
  const float2* spec2 = reinterpret_cast<const float2*>(spec);
  const size_t b_stride = size_t(s.Cin) * s.K;
  const int groups = (L.bt + 3) / 4;
  for (int item = threadIdx.x; item < ks * kCols2 * groups; item += kThreads2) {
    const int k = item % ks, rest = item / ks;
    const int mm = rest % kCols2, grp = rest / kCols2, m = m0 + mm;
    const int nb = max(0, min(min(4, L.bt - grp * 4), s.B - b0 - grp * 4));
    float ar[4] = {0.f, 0.f, 0.f, 0.f}, ai[4] = {0.f, 0.f, 0.f, 0.f};
    if (k < kc && m < s.m2) {
      const float2* sp = spec2 + (size_t(m) * s.B + b0 + grp * 4) * b_stride + k0 + k;
#pragma unroll 4
      for (int c = 0; c < s.Cin; ++c) {
        const float ur = wsr[(c * ks + k) * kCols2 + mm];
        const float ui = wsi[(c * ks + k) * kCols2 + mm];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nb) {
            const float2 v = __ldcg(sp + j * b_stride + size_t(c) * s.K);
            ar[j] = fmaf(v.x, ur, fmaf(-v.y, ui, ar[j]));
            ai[j] = fmaf(v.x, ui, fmaf(v.y, ur, ai[j]));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bb = grp * 4 + j;
      if (bb < L.bt) {
        const int n = (bb * kCols2 + mm) * 2;
        store_split(bm + k * L.bm_s + n, bm_lo, ar[j]);
        store_split(bm + k * L.bm_s + n + 1, bm_lo, ai[j]);
        store_split(bm + (ks + k) * L.bm_s + n, bm_lo, -ai[j]);
        store_split(bm + (ks + k) * L.bm_s + n + 1, bm_lo, ar[j]);
      }
    }
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
  const int rows = (s.H + L.slices - 1) / L.slices, h0 = rank * rows;
  const int h1 = min(s.H, h0 + rows), q4 = n_cols / 4;
  const bool whole = mc == kCols2 && s.m2 % 2 == 0;  // 16-byte aligned runs of 16 floats
  for (int i = threadIdx.x; i < max(0, h1 - h0) * q4; i += kThreads2) {
    const int h = h0 + i / q4, n = (i % q4) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < L.slices; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(zp, r) + h * L.zp_s + n);
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    const int bb = n / (2 * kCols2), j = n % (2 * kCols2), b = b0 + bb;  // j: 2*mm + part
    if (b >= s.B) continue;
    float* zr = z + (((size_t(b) * s.Cout + o) * s.H + h) * s.m2 + m0) * 2;
    if (whole) {
      *reinterpret_cast<float4*>(zr + j) = acc;
    } else {
      const float a[4] = {acc.x, acc.y, acc.z, acc.w};
      for (int e = 0; e < 4; ++e)
        if ((j + e) / 2 < mc) zr[j + e] = a[e];
    }
  }
  cluster.sync();  // no block leaves while another still reads its part
}

// ---- S3: inverse rDFT along W and the epilogue -------------------------------------------

template <int kEpilogue>
__global__ void __launch_bounds__(kThreads3) fno2d_inverse_w(
    const float* __restrict__ z,                                     // (B, Cout, H, m2, 2)
    const float* __restrict__ gyre, const float* __restrict__ gyim,  // (m2, W)
    const float* __restrict__ x,                                     // (B, Cin, H, W)
    const float* __restrict__ pk, int pk_si, int pk_so,              // (Cin, Cout) strided
    const float* __restrict__ pb,                                    // (Cout,)
    float* __restrict__ out,                                         // (B, Cout, H, W)
    Shape s, int z_s, int gy_s, int ys_s, int xt_s, int bulk) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* zs = smem + kBarFloats;     // kRows3 x z_s, split: A4(r, 2m + re/im)
  const int zs_lo = kRows3 * z_s;
  float* zraw = zs + 2 * zs_lo;      // kRows3 x z_s: the rows of Z as they come in
  float* gy = zraw + zs_lo;          // J x gy_s: B4(2m + re/im, w)
  float* pks = gy + s.J * gy_s;      // Cin: this output channel's pointwise column
  float* ys = pks + round_up(s.Cin, 4);  // kRows3 x ys_s: the spectral part of y
  float* xt = ys + kRows3 * ys_s;    // Cin x kRows3 x xt_s: x's rows, where xt_s > 0
  const int bo = blockIdx.x, b = bo / s.Cout, o = bo % s.Cout, h0 = blockIdx.y * kRows3;
  constexpr int kWarps3 = kThreads3 / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // The W matrix, and the rows of x for the pointwise term, are the same for every
  // output channel: blocks of consecutive channels form a cluster where the rows allow,
  // and each brings in a share of them, multicast to all
  const size_t hw = size_t(s.H) * s.W;
  const int rows = min(kRows3, s.H - h0);
  const bool x_tile = kEpilogue >= 1 && xt_s > 0;
  const float* xb = x + size_t(b) * s.Cin * hw + size_t(h0) * s.W;
  if (bulk) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = int(cluster.block_rank()), csize = int(cluster.num_blocks());
    if (threadIdx.x == 0) mbar_init(bar);
    cluster.sync();  // every block's barrier is ready before any copy lands
    if (threadIdx.x == 0)
      mbar_expect(bar, (2u * s.m2 + (x_tile ? unsigned(s.Cin) * rows : 0u)) * s.W * 4);
    multicast_rows(gy, 2 * gy_s, gyre, s.W, s.m2, s.W, bar, rank, csize);
    multicast_rows(gy + gy_s, 2 * gy_s, gyim, s.W, s.m2, s.W, bar, rank, csize);
    zero_pad(gy, 2 * gy_s, s.m2, s.W, s.m2, s.Wp8);
    zero_pad(gy + gy_s, 2 * gy_s, s.m2, s.W, s.m2, s.Wp8);
    if (x_tile)
      for (int c = 0; c < s.Cin; ++c)
        multicast_rows(xt + c * kRows3 * xt_s, xt_s, xb + c * hw, s.W, rows, s.W, bar, rank,
                       csize);
  } else {
    stage_rows(gy, 2 * gy_s, gyre, s.W, s.m2, s.W, s.m2, s.Wp8);
    stage_rows(gy + gy_s, 2 * gy_s, gyim, s.W, s.m2, s.W, s.m2, s.Wp8);
  }
  wait_prerequisites();  // Z is S2's
  stage_rows(zraw, z_s, z + (size_t(bo) * s.H + h0) * 2 * s.m2, 2 * s.m2, rows, 2 * s.m2,
             kRows3, s.J);
  cp_async_commit();
  for (int i = threadIdx.x; i < (s.J - 2 * s.m2) * gy_s; i += kThreads3)
    gy[2 * s.m2 * gy_s + i] = 0.f;
  if (kEpilogue >= 1)
    for (int c = threadIdx.x; c < s.Cin; c += kThreads3) pks[c] = pk[c * pk_si + o * pk_so];
  cp_async_wait<0>();
  if (bulk) mbar_wait(bar, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows3 * s.J; i += kThreads3) {  // every warp reads all
    const int r = i / s.J, c = i % s.J;                            // of them: split once
    store_split(zs + r * z_s + c, zs_lo, zraw[r * z_s + c]);
  }
  __syncthreads();

  for (int n0 = warp * 2; n0 < s.Wp8 / 8; n0 += 2 * kWarps3) {  // 2 n-tiles a warp
    float d[2][4];
    warp_tiles<2, true, false>(d, zs, z_s, 1, zs_lo, gy + n0 * 8, gy_s, 1, 0, s.J);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(ys + (g + half * 8) * ys_s + (n0 + j) * 8 + 2 * t) =
            make_float2(d[j][2 * half], d[j][2 * half + 1]);
  }
  __syncthreads();

  // the epilogue over the tile, 4 columns a thread where the rows of x and y are 16-byte
  // aligned; x's rows come from shared memory where they were staged, else from L2 with
  // the loads of several input channels in flight at once
  const bool quads = s.W % 4 == 0 && (x_tile || (reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                     (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int per_row = quads ? s.W / 4 : s.W;
  const float bias = kEpilogue >= 1 ? __ldg(pb + o) : 0.f;
  float* ob = out + (size_t(b) * s.Cout + o) * hw + size_t(h0) * s.W;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads3) {
    const int r = i / per_row, w = quads ? (i % per_row) * 4 : i % per_row;
    const int n = quads ? 4 : 1;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? ys[r * ys_s + w + e] : 0.f;
    if (x_tile) {
      const float* xp = xt + r * xt_s + w;
      if (quads) {
#pragma unroll 4
        for (int c = 0; c < s.Cin; ++c) {
          const float4 xv = *reinterpret_cast<const float4*>(xp + c * kRows3 * xt_s);
          v[0] = fmaf(xv.x, pks[c], v[0]);
          v[1] = fmaf(xv.y, pks[c], v[1]);
          v[2] = fmaf(xv.z, pks[c], v[2]);
          v[3] = fmaf(xv.w, pks[c], v[3]);
        }
      } else {
        for (int c = 0; c < s.Cin; ++c) v[0] = fmaf(xp[c * kRows3 * xt_s], pks[c], v[0]);
      }
    } else if (kEpilogue >= 1) {
      const float* xp = xb + size_t(r) * s.W + w;
      if (quads) {
#pragma unroll 8
        for (int c = 0; c < s.Cin; ++c) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(xp + c * hw));
          v[0] = fmaf(xv.x, pks[c], v[0]);
          v[1] = fmaf(xv.y, pks[c], v[1]);
          v[2] = fmaf(xv.z, pks[c], v[2]);
          v[3] = fmaf(xv.w, pks[c], v[3]);
        }
      } else {
#pragma unroll 8
        for (int c = 0; c < s.Cin; ++c) v[0] = fmaf(__ldg(xp + c * hw), pks[c], v[0]);
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

template <int kEpilogue>
cudaError_t launch_inverse_w(dim3 grid, size_t smem, int csize, int device,
                             cudaStream_t stream, const float* z, const float* gyre,
                             const float* gyim, const float* x, const float* pk, int pk_si,
                             int pk_so, const float* pb, float* out, const Shape& s, int z_s,
                             int gy_s, int ys_s, int xt_s, int bulk) {
  static bool raised[kMaxDevices] = {};
  cudaError_t err = allow_smem(fno2d_inverse_w<kEpilogue>, smem, device, raised);
  if (err != cudaSuccess) return err;
  return launch_clusters(fno2d_inverse_w<kEpilogue>, grid, kThreads3, smem, dim3(csize), stream,
                         z, gyre, gyim, x, pk, pk_si, pk_so, pb, out, s, z_s, gy_s, ys_s, xt_s,
                         bulk);
}

// The three launches of one layer; `device` is current.
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
  const Layout1 L1 = layout1(s);
  const Layout2 L2 = layout2(s);
  const int z_s = stride_rows(s.J), gy_s = stride_cols(s.Wp8);
  const int ys_s = round_up(s.Wp8, 32) + 8;  // 8-byte stores of a half-warp on distinct banks
  size_t smem3 = (kBarFloats + size_t(kRows3) * (3 * z_s + ys_s) + size_t(s.J) * gy_s +
                  round_up(Cin, 4)) * sizeof(float);
  // Where the rows of the W matrix and of x are whole 16-byte pieces, S3 clusters up to 4
  // output channels' blocks, which take the matrix by multicast bulk copies, and x's rows
  // for the pointwise term too where two blocks still fit on an SM. Elsewhere each block
  // stages the matrix with cp.async and reads x from L2: staging x's rows per block was
  // slower than that (PERF.md section 6).
  const int bulk3 = W % 4 == 0 && aligned16(gyre) && aligned16(gyim) && aligned16(x);
  const int csize3 = !bulk3 ? 1 : Cout % 4 == 0 ? 4 : Cout % 2 == 0 ? 2 : 1;
  const size_t x_tile = size_t(Cin) * kRows3 * W * sizeof(float);
  const int xt_s = bulk3 && epilogue >= 1 && smem3 + x_tile <= kMaxSmem / 2 ? W : 0;
  if (xt_s > 0) smem3 += x_tile;
  if (L1.bytes > kMaxSmem || L2.bytes > kMaxSmem || smem3 > kMaxSmem)
    return cudaErrorInvalidValue;

  static bool raised1[kMaxDevices] = {}, raised2[kMaxDevices] = {};
  cudaError_t err = allow_smem(fno2d_forward_transform, L1.bytes, device, raised1);
  if (err != cudaSuccess) return err;
  const dim3 grid1(B * Cin, (m2 + kCols1 - 1) / kCols1);
  fno2d_forward_transform<<<grid1, kThreads1, L1.bytes, stream>>>(x, fyre, fyim, fxre, fxim,
                                                                 spec, s, L1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_smem(fno2d_mix_inverse_h, L2.bytes, device, raised2);
  if (err != cudaSuccess) return err;
  const dim3 grid2(L2.slices * ((m2 + kCols2 - 1) / kCols2), Cout, (B + L2.bt - 1) / L2.bt);
  err = launch_clusters(fno2d_mix_inverse_h, grid2, kThreads2, L2.bytes, dim3(L2.slices),
                        stream, spec, wr, wi, gxre, gxim, z, s, L2);
  if (err != cudaSuccess) return err;

  const dim3 grid3(B * Cout, (H + kRows3 - 1) / kRows3);
#define FNO2D_LAUNCH(E)                                                                   \
  launch_inverse_w<E>(grid3, smem3, csize3, device, stream, z, gyre, gyim, x, pk, pk_si,      \
                      pk_so, pb, out, s, z_s, gy_s, ys_s, xt_s, bulk3)
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
