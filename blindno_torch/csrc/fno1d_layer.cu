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
// Work and bound at the fpe1d serving shapes, per layer call:
//   heads   B=16, C=30, N=100, M=15: x 192 KB + y 192 KB + wr,wi 108 KB + pk,pb 4 KB
//           = 0.50 MB, 0.15 us at 3.35 TB/s. With the transforms done as FFTs the
//           function needs ~6 MFLOP (of which the pointwise term is half), 0.09 us at
//           67 TFLOP/s (H100 SXM f32 outside the tensor cores, at 700 W): bound by bytes.
//   branch  B=1600, C=4, N=100, M=12 (the FNO-branch model's inner FNO1d): x and y
//           2.56 MB each, 5.1 MB in all, 1.5 us: bound by bytes.
// chip_smoke.py computes these bounds from its own shapes and prints them beside the
// measured times and the card's nvidia-smi name and power limit (PERF.md).
//
// Design. Unlike the 2-D layer, one row's whole (C, N) tile fits in shared memory
// (12 KB at the heads' shape), so one launch does the whole layer with no scratch
// buffer. The Pallas kernel runs grid=(B,), which at B=16 would fill 16 of 132 SMs, so
// the grid is (row groups, output-channel chunks):
//   - a block takes `rows` batch rows and `oc` output channels. `oc` is the fewest
//     channels that keep B * ceil(Cout/oc) blocks within one wave of the SMs (heads:
//     oc=4, 8 chunks, 128 blocks); each block recomputes its rows' forward spectrum,
//     which costs C*N*M complex multiply-adds (45k at the heads' shape). `rows` grows
//     (to at most 8) while a block would leave threads idle and the grid still fills
//     the SMs (branch: 8 rows of 4 channels, 200 blocks).
//   - the weights are the largest input (108 KB at the heads' shape, 160 KB at the
//     GPE widths), so a block reads only its own output channels' slice, through L2.
//   - there are no DFT matrices: the block builds one cos/sin table of N entries in
//     shared memory (in double, rounded to f32) and indexes it by n*k mod N, kept as a
//     running sum. M (12-40) and N (100, 160) need not be powers of two or multiples
//     of 32: every loop runs over its true extent.
// Stages in the block: stage the rows and the table; forward rDFT (one thread per
// (row, channel, mode)); mix into the block's channels with the inverse's a_k folded
// in; inverse rDFT with the pointwise term, bias and gelu fused into the store (one
// thread per (row, channel, point), coalesced along N). One launch on the caller's
// stream, no synchronisation, no allocation. No tensor cores or TMA: this version is
// the correct, simple one.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using blindno::allow_smem;
using blindno::kMaxDevices;
using blindno::kMaxSmem;

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;

size_t smem_bytes(int rows, int oc, int Cin, int N, int M) {
  return (2 * size_t(N) + size_t(rows) * Cin * N + 2 * size_t(rows) * Cin * M +
          2 * size_t(rows) * oc * M) * sizeof(float);
}

// kEpilogue: 0 spectral conv only, 1 + pointwise term and bias, 2 + exact gelu.
template <int kEpilogue>
__global__ void __launch_bounds__(kThreads) fno1d_layer(
    const float* __restrict__ x,                                  // (B, Cin, N)
    const float* __restrict__ wr, const float* __restrict__ wi,   // (Cin, Cout, M)
    const float* __restrict__ pk, int pk_si, int pk_so,           // (Cin, Cout) strided
    const float* __restrict__ pb,                                 // (Cout,)
    float* __restrict__ out,                                      // (B, Cout, N)
    int B, int Cin, int Cout, int N, int M, int dc_half, int rows, int oc) {
  extern __shared__ float smem[];
  const int b0 = blockIdx.x * rows, rb = min(rows, B - b0);
  const int o0 = blockIdx.y * oc, ob = min(oc, Cout - o0);
  float* cos_t = smem;                   // N: cos(2 pi j / N)
  float* sin_t = cos_t + N;              // N: sin(2 pi j / N)
  float* xs = sin_t + N;                 // rows * Cin * N
  float* xr = xs + rows * Cin * N;       // rows * Cin * M: forward spectrum
  float* xi = xr + rows * Cin * M;
  float* yr = xi + rows * Cin * M;       // rows * oc * M: mixed spectrum times a_k
  float* yi = yr + rows * oc * M;

  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    double s, c;
    sincospi(2.0 * j / N, &s, &c);
    cos_t[j] = float(c);
    sin_t[j] = float(s);
  }
  const float* xp = x + size_t(b0) * Cin * N;
  for (int i = threadIdx.x; i < rb * Cin * N; i += blockDim.x) xs[i] = xp[i];
  __syncthreads();

  // truncated rDFT of every (row, input channel); t = n*k mod N
  for (int i = threadIdx.x; i < rb * Cin * M; i += blockDim.x) {
    const int k = i % M;
    const float* v = xs + (i / M) * N;
    float ar = 0.f, ai = 0.f;
    int t = 0;
    for (int n = 0; n < N; ++n) {
      ar = fmaf(v[n], cos_t[t], ar);
      ai = fmaf(-v[n], sin_t[t], ai);
      t += k;
      if (t >= N) t -= N;
    }
    const float h = (dc_half && k == 0) ? 0.5f : 1.f;
    xr[i] = ar * h;
    xi[i] = ai * h;
  }
  __syncthreads();

  // per-mode complex mix into the block's output channels, times the inverse's a_k
  const float inv_n = 1.f / N;
  for (int i = threadIdx.x; i < rb * ob * M; i += blockDim.x) {
    const int k = i % M, ro = i / M, o = o0 + ro % ob, r = ro / ob;
    const float* sr = xr + r * Cin * M + k;
    const float* si = xi + r * Cin * M + k;
    float ar = 0.f, ai = 0.f;
    for (int c = 0; c < Cin; ++c) {
      const size_t q = (size_t(c) * Cout + o) * M + k;
      const float ur = __ldg(wr + q), ui = __ldg(wi + q);
      const float vr = sr[c * M], vi = si[c * M];
      ar = fmaf(vr, ur, fmaf(-vi, ui, ar));
      ai = fmaf(vr, ui, fmaf(vi, ur, ai));
    }
    const float a = (k == 0 || 2 * k == N) ? inv_n : 2.f * inv_n;
    yr[i] = ar * a;
    yi[i] = ai * a;
  }
  __syncthreads();

  // inverse rDFT (real part) of every (row, output channel), then the epilogue
  for (int i = threadIdx.x; i < rb * ob * N; i += blockDim.x) {
    const int n = i % N, ro = i / N, o = o0 + ro % ob, r = ro / ob;
    const float* vr = yr + ro * M;
    const float* vi = yi + ro * M;
    float acc = 0.f;
    int t = 0;
    for (int k = 0; k < M; ++k) {
      acc = fmaf(vr[k], cos_t[t], acc);
      acc = fmaf(-vi[k], sin_t[t], acc);
      t += n;
      if (t >= N) t -= N;
    }
    if (kEpilogue >= 1) {
      const float* xn = xs + r * Cin * N + n;
      float p = 0.f;
      for (int c = 0; c < Cin; ++c) p = fmaf(xn[c * N], __ldg(pk + c * pk_si + o * pk_so), p);
      acc += p + __ldg(pb + o);
    }
    if (kEpilogue == 2) acc = 0.5f * acc * (1.f + erff(acc * 0.70710678118654752f));
    out[(size_t(b0 + r) * Cout + o) * N + n] = acc;
  }
}

template <int kEpilogue>
cudaError_t launch(dim3 grid, size_t smem, int device, cudaStream_t stream, const float* x,
                   const float* wr, const float* wi, const float* pk, int pk_si, int pk_so,
                   const float* pb, float* out, int B, int Cin, int Cout, int N, int M,
                   int dc_half, int rows, int oc) {
  static bool raised[kMaxDevices] = {};
  cudaError_t err = allow_smem(fno1d_layer<kEpilogue>, smem, device, raised);
  if (err != cudaSuccess) return err;
  fno1d_layer<kEpilogue><<<grid, kThreads, smem, stream>>>(
      x, wr, wi, pk, pk_si, pk_so, pb, out, B, Cin, Cout, N, M, dc_half, rows, oc);
  return cudaGetLastError();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Choose the block shape (see the note at the top) and launch; `device` is current.
cudaError_t launch_layer(const float* x, const float* wr, const float* wi, const float* pk,
                         int pk_si, int pk_so, const float* pb, float* out, int B, int Cin,
                         int Cout, int N, int M, int dc_half, int epilogue, int device,
                         cudaStream_t s) {
  if (B == 0 || Cout == 0) return cudaSuccess;
  static int sms[kMaxDevices] = {};
  if (sms[device] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int chunks = max(1, min(Cout, sms[device] / B));
  const int oc = ceil_div(Cout, chunks);
  const int grid_y = ceil_div(Cout, oc);
  int rows = 1;
  while (rows < kMaxRows && rows * Cin * M < kThreads &&
         ceil_div(B, 2 * rows) * grid_y >= sms[device] &&
         smem_bytes(2 * rows, oc, Cin, N, M) <= blindno::kDefaultSmem)
    rows *= 2;
  const size_t smem = smem_bytes(rows, oc, Cin, N, M);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid(ceil_div(B, rows), grid_y);
#define FNO1D_LAUNCH(E) \
  launch<E>(grid, smem, device, s, x, wr, wi, pk, pk_si, pk_so, pb, out, B, Cin, Cout, N, M, \
            dc_half, rows, oc)
  switch (epilogue) {
    case 0: return FNO1D_LAUNCH(0);
    case 1: return FNO1D_LAUNCH(1);
    default: return FNO1D_LAUNCH(2);
  }
#undef FNO1D_LAUNCH
}

}  // namespace

extern "C" {

// One FNO1d layer. `epilogue`: 0 spectral conv only (spectral_conv1d), 1 adds the
// pointwise term and bias, 2 also applies the exact gelu (fno1d_layer). `dc_half`
// (0 or 1) halves the DC coefficient before the mix. pk may have any strides (pk_si,
// pk_so in elements); pk and pb may be null when `epilogue` is 0. One launch to
// `device` on `stream`; the calling thread's current device is the same on return.
// Returns the CUDA error code (0 on success; the text is blindno_error_string's).
int fno1d_layer_forward(const float* x, const float* wr, const float* wi, const float* pk,
                        int pk_si, int pk_so, const float* pb, float* out, int B, int Cin,
                        int Cout, int N, int M, int dc_half, int epilogue, int device,
                        void* stream) {
  if (epilogue < 0 || epilogue > 2 || B < 0 || Cin < 1 || Cout < 0 || M < 1 ||
      M > N / 2 + 1)
    return cudaErrorInvalidValue;
  return blindno::on_device(device, [&] {
    return launch_layer(x, wr, wi, pk, pk_si, pk_so, pb, out, B, Cin, Cout, N, M, dc_half,
                        epilogue, device, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
