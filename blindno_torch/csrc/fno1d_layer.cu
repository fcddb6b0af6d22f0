// One FNO1d layer on Hopper (sm_90a), f32 with f32 accumulation.
//
// Replaces the TPU kernels `fno1d_layer_pallas` (blindno/ops/spectral_pallas.py:69-99)
// and `spectral_conv1d_pallas` (:201-231). Both compute, per batch row x (C, N),
//   X[c, k] = sum_n x[c, n] e^{-2 pi i n k / N}, k < M    (truncated rDFT; X[c, 0] halved
//                                                          when dc_half)
//   Y[o, k] = sum_c X[c, k] (wr + i wi)[c, o, k]          (per-mode complex channel mix)
//   y[o, n] = sum_k a_k Re(Y[o, k] e^{+2 pi i n k / N})   (inverse, a_k = 1/N for the DC
//                                                          and a kept Nyquist mode, else 2/N)
//   y += pk^T x + pb ; y = gelu_erf(y)                    (optional epilogue)
// as the plain PyTorch version blindno_torch/ops/fno_layer.py does with dense DFT
// matrices; the result matches it up to summation order and the last bit of the twiddles.
//
// Bound, per layer call (chip_smoke.py computes it from its own shapes and prints it
// beside the measured time and the card's nvidia-smi name and power limit; PERF.md):
//   fpe1d heads  B=16, C=30, N=100, M=15: x, y, wr, wi, pk, pb = 0.50 MB, 0.15 us at
//                3.35 TB/s; 6.3 MFLOP with the transforms as FFTs, 0.09 us at 67 TFLOP/s
//                (f32 outside the tensor cores, 700 W): bound by bytes.
//   GPE heads    B=16, C=20, N=160, M=40: 0.54 MB, 0.16 us: bound by bytes.
//   FNO branch   B=1600, C=4, N=100, M=12 (the FNO-branch model's inner FNO1d): x and y
//                2.56 MB each, 5.1 MB in all, 1.53 us: bound by bytes.
// Every served call needs well under 2 us of the card, so the kernel is bound by
// latency: the launch, the chain of dependent stages inside a block, L2 round trips.
//
// What limited the one-launch kernel this replaces (15.0 us at the heads, 25.5 us at
// the branch, 24.8 us at the GPE heads): each of a row's 8 output-channel blocks
// recomputed the row's whole forward spectrum with 100-step dependent chains of
// scattered table reads; the mix ran on 60 of 256 threads, each walking 30 channels of
// weights in L2; the pointwise term read pk from L2 at every output point; the branch
// shape ran 200 blocks of 8 rows; and each layer call drained before the next started.
//
// Design: one launch on the caller's stream, grid (row groups, output-channel chunks),
// 256 threads, no scratch in global memory. Stages in a block: before
// griddepcontrol.wait, a table (cos, sin)(2 pi j / N) for j < N (in double, rounded to
// f32) and the twiddle tile built from it; then the chunk's weights, pk and pb staged,
// the rows of x, the forward transform of the block's input-channel share (the DC
// halved), the exchange over the cluster, the mix into the block's output channels with
// a_k folded in, and the inverse transform with the pointwise term, bias and gelu fused
// into the store (coalesced along N). Each element, against the variant without it
// (blindno_torch/tools/ab_fno.py --dim 1 --design: medians of 10 alternating rounds of
// CUDA-graph replays in one call, layer with gelu / spectral conv alone, in us at the
// heads, branch and GPE heads; on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6
// has the same rows from the proof run):
//   committed design                      7.89/6.46  12.03/9.84   10.17/9.38
//   the kernel this replaces             14.91/12.74 25.29/21.57  24.59/23.27
//   - Programmatic dependent launch (blindno::launch_clusters): a layer call starts
//     while the call before it runs, so its table and tile overlap that call's tail.
//     Before the wait a block reads and writes no global memory: the kernel before may
//     write this call's weights (a cast, a copy, an optimizer step) or read the buffer
//     that the caching allocator hands this call for its output. After it, x comes in
//     through L2 (cp.async.cg or ld.global.cg), never the read-only path.
//     Plain launches:                      9.32/7.92  13.30/10.92  12.66/11.90
//     The weights staged before the wait instead (wrong where the kernel before writes
//     them; what the safe order costs):    7.35/6.16  11.86/9.48    9.46/8.61
//   - Weights in shared memory: the chunk's slice of wr, wi (interleaved re/im) and of
//     pk, pb by cp.async, instead of reads from L2 in the mix:
//                                         11.09/8.51  14.37/12.08  10.86/10.11
//   - A twiddle tile (cos, sin)(2 pi n k / N) for n < N, k < M, built from the table,
//     instead of reading the table at n*k mod N (4-channel inverse items kept):
//                                         13.26/22.25 19.34/26.07  15.08/12.90
//     with an odd row stride in float2, so that reads down a column hit distinct banks
//     (a stride of a multiple of 4:        8.61/7.64  13.72/11.56  13.17/12.18).
//   - Inverse items of 4 output channels at one point, so that each twiddle read
//     serves 4 outputs (1 channel:         8.30/6.74  15.54/11.72  10.87/9.60).
//   - Forward items of 4 modes of one channel, so that each x read serves 4, where
//     items of one mode would take the block more than one pass (the fpe1d heads and
//     the branch; 1 mode there:            8.09/6.99  12.57/10.34), else of one mode,
//     so that more threads share the sums (the GPE heads; 4 modes there: 13.88/12.73).
//   - x by 16-byte cp.async.cg where x is 16-byte aligned and N a multiple of 4, else
//     ld.global.cg (always the latter:     9.93/8.45  13.88/11.72  11.11/10.32).
//   - Items decoded with divisors fixed at launch (FastDiv), not integer division:
//                                          8.39/6.87  13.02/10.44  10.45/9.32
//   - A cluster of all of a row's chunks shares one forward spectrum where the row's
//     forward is large (Cin * M * N > kClusterForward: the GPE heads, 8 blocks): each
//     block transforms its share of the input channels and writes it into every peer's
//     shared memory (distributed shared memory). No cluster there: 20.64/19.76 at the
//     GPE heads; a cluster at the fpe1d heads too: 7.89/6.66.
//   - Batch rows per block where the batch alone fills the SMs, at least a block per
//     SM (the branch: 8 rows, 200 blocks; 4 rows, 400 blocks: 13.00/11.14).
// Stage boundaries, timed by variants that return there (same call, heads with gelu):
// launch alone 1.21, up to the wait 1.64, after the forward and the exchange 5.69,
// after the mix 6.45, the whole layer 7.89 us.
// Registers and spills of each instantiation are in the build log (`-Xptxas -v`,
// chip_smoke.py phase `build`).
//
// Shapes: any B, Cin >= 1, Cout >= 0, 1 <= M <= N/2 + 1. Where a whole row (its x, the
// twiddle tile and the staged weights) does not fit in a block's 227 KB, the kernel
// first stops staging weights, then tiles along N (each tile's x and twiddles, the
// spectrum summed over the tiles, the inverse tile by tile), and last drops the twiddle
// tile for direct reads of the table with one output channel a block: that last layout
// needs no more shared memory than the one-row tile of the kernel this replaces, so every
// shape that kernel took still runs (tests/test_torch_kernels_cuda.py holds N=4096 in
// tiles and M=1001 from the table alone).

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

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxRows = 8;
constexpr int kMinTile = 32;    // fewest points of an N tile that keeps the twiddle tile
// complex products of a row's forward transform above which a row's chunks share it in
// a cluster: below, the exchange and the cluster barrier cost more than they save
constexpr int kClusterForward = 49152;
// modes of a forward item where items of one mode would take the block more than a pass
constexpr int kFwdGroup = 4;

struct LayerArgs {
  const float* x;                // (B, Cin, N)
  const float* wr;               // (Cin, Cout, M)
  const float* wi;
  const float* pk;               // (Cin, Cout), element strides pk_si, pk_so
  const float* pb;               // (Cout,)
  float* out;                    // (B, Cout, N)
  int B, Cin, Cout, N, M, dc_half, pk_si, pk_so;
};

// Division by a number fixed at launch, for numerators below 2^31 (Granlund and
// Montgomery's round-up method): n / d = (umulhi(n, m) + n) >> l.
struct FastDiv {
  unsigned m, l;
};

FastDiv fast_div(unsigned d) {
  unsigned l = 0;
  while ((uint64_t(1) << l) < d) ++l;
  return {unsigned(((uint64_t(1) << 32) * ((uint64_t(1) << l) - d)) / d + 1), l};
}

__device__ __forceinline__ int operator/(int n, FastDiv f) {
  return int((__umulhi(unsigned(n), f.m) + unsigned(n)) >> f.l);
}

// The block shape and shared-memory layout that launch_layer picks; offsets in floats.
// An item of a stage is decoded with the divisors below (the shares of input and output
// channels are taken at their largest, and the items past a block's own share idle).
struct Layout {
  int rows;      // batch rows of a block (grid.x = ceil(B / rows))
  int chunks;    // output-channel chunks of a row (grid.y)
  int cs;        // consecutive chunks in a cluster, sharing one forward spectrum
  int ncm;       // most input channels of a cluster rank's share
  int oc, ocp;   // most output channels of a chunk, and that rounded up to whole items
  int nt;        // points of an N tile (N where a row fits)
  int fm;        // modes of a forward item: 1 where items of one mode fit in one pass of
                 // the block, else kFwdGroup, so that each x read serves them
  int ts;        // row stride of the twiddle tile, in float2: odd, and past M rounded up
                 // to whole kFwdGroup items
  int stage_w;   // the chunk's weights are staged in shared memory (else read from L2)
  int vec_x;     // x comes in by 16-byte copies
  int tab, tw, xs, spec, w, p, y;
  FastDiv by_kgs, by_ncm, by_m, by_oc, by_ogs, by_nt;
  size_t bytes;
};

// Output channels of an inverse item: 4 with the twiddle tile, 1 in the layout without.
__host__ __device__ constexpr int inverse_channels(bool tile) { return tile ? 4 : 1; }

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// (cos, sin)(2 pi n k / N): from the twiddle tile (point nl of the tile), or, in the
// layout without one, from the table.
template <bool kTile>
struct Twiddles {
  const float2* tile;
  int ts;
  const float2* table;
  unsigned N;
  __device__ __forceinline__ float2 at(int nl, int n, int k) const {
    if (kTile) return tile[nl * ts + k];
    return table[unsigned(n) * unsigned(k) % N];
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {  // release: this block's writes first
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {  // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// kEpilogue: 0 spectral conv only, 1 + pointwise term and bias, 2 + exact gelu.
// kTile: the twiddles come from the twiddle tile (else straight from the table).
// kF: modes of a forward item (Layout::fm).
template <int kEpilogue, bool kTile, int kF>
__global__ void __launch_bounds__(kThreads) fno1d_layer(LayerArgs a, Layout L) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kWarps = kThreads / 32;
  constexpr int kO = inverse_channels(kTile);
  const int N = a.N, M = a.M, Cin = a.Cin, Cout = a.Cout;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float2* table = reinterpret_cast<float2*>(smem + L.tab);  // N: (cos, sin)(2 pi j / N)
  float2* tile = reinterpret_cast<float2*>(smem + L.tw);    // nt x ts
  float* xs = smem + L.xs;                                   // rows x Cin x nt
  float2* spec = reinterpret_cast<float2*>(smem + L.spec);  // rows x Cin x M
  float* ws = smem + L.w;                                    // Cin x oc x M x (re, im)
  float* ps = smem + L.p;                                    // Cin x ocp, then ocp biases
  float2* ys = reinterpret_cast<float2*>(smem + L.y);       // rows x ocp x M
  const Twiddles<kTile> tw{tile, L.ts, table, unsigned(N)};

  const int b0 = blockIdx.x * L.rows, rb = min(L.rows, a.B - b0);
  const int chunk = blockIdx.y, o0 = chunk * Cout / L.chunks;
  const int ob = (chunk + 1) * Cout / L.chunks - o0;
  const int rank = chunk % L.cs;  // the block's rank in its cluster
  const int c0 = rank * Cin / L.cs, nc = (rank + 1) * Cin / L.cs - c0;
  const int tiles = (N + L.nt - 1) / L.nt;

  if (L.cs > 1) cluster_arrive_relaxed();  // waited for before the first remote write

  // ---- before the wait: only the layer's constants ----
  {
    const double step = 2.0 / N;
    for (int j = tid; j < N; j += kThreads) {
      double s, c;
      sincospi(step * j, &s, &c);
      table[j] = make_float2(float(c), float(s));
    }
  }
  // the chunk's weights (re and im interleaved), pk and pb: after the wait, since the
  // kernel before may write them (a cast, a copy, an optimizer step)
  auto stage_weights = [&] {
    if (L.stage_w)
      for (int c = warp; c < Cin; c += kWarps)
        for (int ok = lane; ok < ob * M; ok += 32) {
          const size_t q = (size_t(c) * Cout + o0) * M + ok;
          float* d = ws + 2 * (c * L.oc * M + ok);
          cp_async4(d, a.wr + q);
          cp_async4(d + 1, a.wi + q);
        }
    if (kEpilogue >= 1) {
      for (int c = warp; c < Cin; c += kWarps)
        for (int o = lane; o < ob; o += 32)
          cp_async4(ps + c * L.ocp + o, a.pk + size_t(c) * a.pk_si + size_t(o0 + o) * a.pk_so);
      for (int o = tid; o < ob; o += kThreads) cp_async4(ps + Cin * L.ocp + o, a.pb + o0 + o);
    }
    cp_async_commit();
  };
  // a thread per point n of the tile, along k
  auto build_tile = [&](int n0, int nt) {
    for (int nl = tid; nl < nt; nl += kThreads)
      for (int k = 0; k < M; ++k) tile[nl * L.ts + k] = table[unsigned(n0 + nl) * k % N];
  };
  __syncthreads();  // the table
  if (kTile) build_tile(0, min(L.nt, N));

  blindno::wait_prerequisites();  // the kernel before has ended: x and the weights are ready
  blindno::launch_dependents();
  stage_weights();

  // rows b0.. of x, all input channels, points [n0, n0 + nt), through L2: a warp per
  // (row, channel), its lanes along N
  auto load_x = [&](int n0, int nt) {
    const float* xp = a.x + size_t(b0) * Cin * N + n0;
    for (int r = warp; r < rb * Cin; r += kWarps) {
      if (L.vec_x) {
        for (int j = 4 * lane; j < nt; j += 128)
          cp_async16(xs + r * L.nt + j, xp + size_t(r) * N + j, 16);
      } else {
        for (int j = lane; j < nt; j += 32) xs[r * L.nt + j] = __ldcg(xp + size_t(r) * N + j);
      }
    }
    cp_async_commit();
  };

  // the forward's last tile writes each spectrum entry of the block's share into this
  // block and every peer of its cluster (distributed shared memory, the same offset)
  cg::cluster_group cluster = cg::this_cluster();
  if (L.cs > 1) cluster_wait();  // every block of the cluster runs: it may be written

  // ---- forward transform of the block's input-channel share, summed over the tiles:
  // an item is kF consecutive modes of one (row, channel) ----
  const int kgs = (M + kF - 1) / kF;
  for (int t = 0; t < tiles; ++t) {
    const int n0 = t * L.nt, nt = min(L.nt, N - n0);
    if (t > 0) {
      __syncthreads();  // the previous tile is used
      if (kTile) build_tile(n0, nt);
    }
    load_x(n0, nt);
    cp_async_wait<0>();
    __syncthreads();
    const int items = rb * L.ncm * kgs;
    for (int it = tid; it < items; it += kThreads) {
      const int rc = it / L.by_kgs, r = rc / L.by_ncm;
      const int k0 = kF * (it - rc * kgs), cl = rc - r * L.ncm, c = c0 + cl;
      if (cl >= nc) continue;
      float re[kF] = {}, im[kF] = {};
      const float* xr = xs + (r * Cin + c) * L.nt;
      for (int nl = 0; nl < nt; ++nl) {
        const float xv = xr[nl];
#pragma unroll
        for (int j = 0; j < kF; ++j) {  // past M: the tile's padding, never stored
          const float2 e = tw.at(nl, n0 + nl, k0 + j);
          re[j] = fmaf(xv, e.x, re[j]);
          im[j] = fmaf(xv, e.y, im[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kF; ++j) {
        const int k = k0 + j, e = (r * Cin + c) * M + k;
        if (k >= M) continue;
        const float h = (a.dc_half && k == 0) ? 0.5f : 1.f;
        float2 v = make_float2(re[j] * h, -im[j] * h);
        if (t > 0) v = make_float2(spec[e].x + v.x, spec[e].y + v.y);
        spec[e] = v;
        if (t == tiles - 1)
          for (int q = 1; q < L.cs; ++q)
            *cluster.map_shared_rank(spec + e, (rank + q) % L.cs) = v;
      }
    }
  }
  if (L.cs > 1) {
    cluster_arrive();  // this block's share is in every peer ...
    cluster_wait();    // ... and every peer's share is here
  } else {
    __syncthreads();
  }

  // ---- mix into the block's output channels, times the inverse's a_k: an item is one
  // (row, channel, mode) ----
  auto mix = [&](auto weight) {
    const float inv_n = 1.f / N;
    const int items = rb * L.oc * M;
    for (int it = tid; it < items; it += kThreads) {
      const int ro = it / L.by_m, r = ro / L.by_oc;
      const int k = it - ro * M, o = ro - r * L.oc;
      if (o >= ob) continue;
      float re = 0.f, im = 0.f;
      const float2* s = spec + r * Cin * M + k;
      for (int c = 0; c < Cin; ++c) {
        const float2 w = weight(c, o, k), v = s[c * M];
        re = fmaf(v.x, w.x, fmaf(-v.y, w.y, re));
        im = fmaf(v.x, w.y, fmaf(v.y, w.x, im));
      }
      const float ak = (k == 0 || 2 * k == N) ? inv_n : 2.f * inv_n;
      ys[(r * L.ocp + o) * M + k] = make_float2(re * ak, im * ak);
    }
  };
  if (L.stage_w) {
    const float2* w2 = reinterpret_cast<const float2*>(ws);
    mix([&](int c, int o, int k) { return w2[(c * L.oc + o) * M + k]; });
  } else {
    mix([&](int c, int o, int k) {
      const size_t q = (size_t(c) * Cout + o0 + o) * M + k;
      return make_float2(__ldcg(a.wr + q), __ldcg(a.wi + q));
    });
  }
  __syncthreads();

  // ---- inverse transform and epilogue, tile by tile: an item is kO consecutive output
  // channels at one (row, point), so that each twiddle read serves kO outputs ----
  const int ogs = L.ocp / kO;
  for (int t = 0; t < tiles; ++t) {
    const int n0 = t * L.nt, nt = min(L.nt, N - n0);
    if (tiles > 1) {
      __syncthreads();  // the previous tile is used
      if (kTile) build_tile(n0, nt);
      if (kEpilogue >= 1) load_x(n0, nt);
      cp_async_wait<0>();
      __syncthreads();
    }
    const int items = rb * ogs * L.nt;
    for (int it = tid; it < items; it += kThreads) {
      const int rg = it / L.by_nt, r = rg / L.by_ogs;
      const int nl = it - rg * L.nt, oa = kO * (rg - r * ogs);
      if (nl >= nt || oa >= ob) continue;
      float acc[kO] = {};
      const float2* yv = ys + (r * L.ocp + oa) * M;  // rows past ob: padding, never stored
      for (int k = 0; k < M; ++k) {
        const float2 e = tw.at(nl, n0 + nl, k);
#pragma unroll
        for (int j = 0; j < kO; ++j) {
          const float2 v = yv[j * M + k];
          acc[j] = fmaf(v.x, e.x, acc[j]);
          acc[j] = fmaf(-v.y, e.y, acc[j]);
        }
      }
      if (kEpilogue >= 1) {
        const float* xv = xs + r * Cin * L.nt + nl;
        for (int c = 0; c < Cin; ++c) {
          const float xc = xv[c * L.nt];
          if constexpr (kO == 4) {
            const float4 p = *reinterpret_cast<const float4*>(ps + c * L.ocp + oa);
            acc[0] = fmaf(xc, p.x, acc[0]);
            acc[1] = fmaf(xc, p.y, acc[1]);
            acc[2] = fmaf(xc, p.z, acc[2]);
            acc[3] = fmaf(xc, p.w, acc[3]);
          } else {
            acc[0] = fmaf(xc, ps[c * L.ocp + oa], acc[0]);
          }
        }
      }
      float* op = a.out + (size_t(b0 + r) * Cout + o0 + oa) * N + n0 + nl;
#pragma unroll
      for (int j = 0; j < kO; ++j) {
        if (oa + j >= ob) continue;
        float v = acc[j];
        if (kEpilogue >= 1) v += ps[Cin * L.ocp + oa + j];
        if (kEpilogue == 2) v = gelu_erf(v);
        op[size_t(j) * N] = v;
      }
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The shared-memory layout of a block shape; `bytes` is what it needs.
Layout layout(int rows, int chunks, int cs, int nt, bool tile, int stage_w, int epilogue,
              int vec_x, int Cin, int Cout, int N, int M) {
  Layout L{};
  L.rows = rows, L.chunks = chunks, L.cs = cs, L.ncm = ceil_div(Cin, cs);
  L.oc = ceil_div(Cout, chunks), L.nt = nt;
  const int ko = inverse_channels(tile);
  L.ocp = (L.oc + ko - 1) / ko * ko;
  L.fm = rows * L.ncm * M > kThreads ? kFwdGroup : 1;
  // odd, so that a half-warp's 8-byte reads down a column hit distinct banks, and past
  // M rounded up to whole kFwdGroup items, so that an item's modes stay in the row
  L.ts = ((M + kFwdGroup - 1) / kFwdGroup * kFwdGroup) | 1;
  L.stage_w = stage_w, L.vec_x = vec_x;
  L.by_kgs = fast_div((M + L.fm - 1) / L.fm), L.by_ncm = fast_div(L.ncm), L.by_m = fast_div(M);
  L.by_oc = fast_div(L.oc), L.by_ogs = fast_div(L.ocp / ko), L.by_nt = fast_div(nt);
  size_t off = 0;
  auto take = [&](size_t floats) {
    const size_t at = off;
    off += (floats + 3) / 4 * 4;  // 16-byte aligned regions
    return int(at);  // used only where `bytes` fits in a block
  };
  L.tab = take(2 * size_t(N));
  L.tw = take(tile ? 2 * size_t(nt) * L.ts : 0);
  L.xs = take(size_t(rows) * Cin * nt);
  L.spec = take(2 * size_t(rows) * Cin * M);
  L.w = take(stage_w ? 2 * size_t(Cin) * L.oc * M : 0);
  L.p = take(epilogue >= 1 ? size_t(Cin + 1) * L.ocp : 0);
  L.y = take(2 * size_t(rows) * L.ocp * M);
  L.bytes = off * sizeof(float);
  return L;
}

// The largest N tile (a multiple of 4, at most N) with which layout() fits; 0 if none.
int largest_tile(int rows, int chunks, int cs, bool tile, int stage_w, int epilogue,
                 int vec_x, int Cin, int Cout, int N, int M) {
  int lo = 0, hi = (N + 3) / 4;  // in units of 4 points
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    const int nt = min(4 * mid, N);
    if (layout(rows, chunks, cs, nt, tile, stage_w, epilogue, vec_x, Cin, Cout, N, M).bytes <=
        kMaxSmem)
      lo = mid;
    else
      hi = mid - 1;
  }
  return min(4 * lo, N);
}

// Choose the block shape (see the note at the top); false if no layout fits.
bool choose(int B, int Cin, int Cout, int N, int M, int epilogue, int sms, bool aligned_x,
            Layout& L, bool& tile) {
  // output-channel chunks of a row: enough to fill the SMs where the batch does not
  int chunks = 1;
  while (chunks * 2 <= kMaxCluster && chunks * 2 <= Cout && B * chunks * 2 <= sms) chunks *= 2;
  // all of a row's chunks share one forward spectrum where the row's forward transform
  // (Cin * M * N complex products) is large
  const int cs = size_t(Cin) * M * N > size_t(kClusterForward) ? chunks : 1;
  // batch rows of a block where the batch fills the SMs alone: at least a block per SM
  int rows = 1;
  if (chunks == 1)
    while (rows * 2 <= kMaxRows && ceil_div(B, rows * 2) >= sms) rows *= 2;
  const int vec_x = aligned_x && N % 4 == 0;
  tile = true;
  // the whole row, the chunk's weights staged or not, fewer rows where they do not fit
  for (; rows >= 1; rows /= 2)
    for (int stage_w = 1; stage_w >= 0; --stage_w) {
      L = layout(rows, chunks, cs, N, true, stage_w, epilogue, vec_x, Cin, Cout, N, M);
      if (L.bytes <= kMaxSmem) return true;
    }
  // tiles along N, each with its twiddle tile
  for (int stage_w = 1; stage_w >= 0; --stage_w) {
    const int nt = largest_tile(1, chunks, cs, true, stage_w, epilogue, vec_x, Cin, Cout, N, M);
    if (nt >= min(N, kMinTile)) {
      L = layout(1, chunks, cs, nt, true, stage_w, epilogue, vec_x, Cin, Cout, N, M);
      return true;
    }
  }
  // the table alone, one output channel a block, weights read from L2
  tile = false;
  const int nt = largest_tile(1, Cout, 1, false, 0, epilogue, vec_x, Cin, Cout, N, M);
  L = layout(1, Cout, 1, max(nt, 1), false, 0, epilogue, vec_x, Cin, Cout, N, M);
  return nt >= 1;
}

template <int kEpilogue, bool kTile, int kF>
cudaError_t launch(const LayerArgs& a, const Layout& L, int device, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  const auto kernel = fno1d_layer<kEpilogue, kTile, kF>;
  cudaError_t err = allow_smem(kernel, L.bytes, device, raised);
  if (err != cudaSuccess) return err;
  return blindno::launch_clusters(kernel, dim3(ceil_div(a.B, L.rows), L.chunks), kThreads,
                                  L.bytes, dim3(1, L.cs, 1), stream, a, L);
}

template <int kEpilogue>
cudaError_t launch(const LayerArgs& a, const Layout& L, bool tile, int device,
                   cudaStream_t stream) {
  if (tile)
    return L.fm == 1 ? launch<kEpilogue, true, 1>(a, L, device, stream)
                     : launch<kEpilogue, true, kFwdGroup>(a, L, device, stream);
  return L.fm == 1 ? launch<kEpilogue, false, 1>(a, L, device, stream)
                   : launch<kEpilogue, false, kFwdGroup>(a, L, device, stream);
}

// Choose the block shape and launch; `device` is current.
cudaError_t launch_layer(const LayerArgs& a, int epilogue, int device, cudaStream_t stream) {
  if (a.B == 0 || a.Cout == 0) return cudaSuccess;
  static int sms[kMaxDevices] = {};
  if (sms[device] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  Layout L;
  bool tile;
  const bool aligned_x = (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  if (!choose(a.B, a.Cin, a.Cout, a.N, a.M, epilogue, sms[device], aligned_x, L, tile))
    return cudaErrorInvalidValue;
  switch (epilogue) {
    case 0: return launch<0>(a, L, tile, device, stream);
    case 1: return launch<1>(a, L, tile, device, stream);
    default: return launch<2>(a, L, tile, device, stream);
  }
}

}  // namespace

extern "C" {

// One FNO1d layer. `epilogue`: 0 spectral conv only (spectral_conv1d), 1 adds the
// pointwise term and bias, 2 also applies the exact gelu (fno1d_layer). `dc_half`
// (0 or 1) halves the DC coefficient before the mix. pk may have any strides (pk_si,
// pk_so in elements); pk and pb may be null when `epilogue` is 0. One launch to
// `device` on `stream`, which may start before the kernel before it on the stream ends
// (programmatic dependent launch): it reads and writes global memory only once that
// kernel has ended. The calling thread's current device is the same on return. Returns
// the CUDA error code (0 on success; the text is blindno_error_string's).
int fno1d_layer_forward(const float* x, const float* wr, const float* wi, const float* pk,
                        int pk_si, int pk_so, const float* pb, float* out, int B, int Cin,
                        int Cout, int N, int M, int dc_half, int epilogue, int device,
                        void* stream) {
  if (epilogue < 0 || epilogue > 2 || B < 0 || Cin < 1 || Cout < 0 || M < 1 ||
      M > N / 2 + 1)
    return cudaErrorInvalidValue;
  const LayerArgs a{x, wr, wi, pk, pb, out, B, Cin, Cout, N, M, dc_half, pk_si, pk_so};
  return blindno::on_device(device, [&] {
    return launch_layer(a, epilogue, device, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
