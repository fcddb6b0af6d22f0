// One FNO2d layer on Hopper (sm_90a), f32 with f32 accumulation.
//
// Replaces the TPU kernels `fno2d_layer_pallas` (blindno/ops/spectral_pallas.py:165-194)
// and `spectral_conv2d_pallas` (:234-266). Both compute, per batch element,
//   y = irDFT_W( iDFT+-_H( mix( DFT+-_H( rDFT_W(x) ) ) ) )          (spectral chain)
//   y += pk^T x + pb ; y = gelu_erf(y)                               (optional epilogue)
// with the truncated DFTs as small dense products against precomputed matrices (built
// in float64 and rounded to f32 by blindno_torch/ops/dft.py), so the result matches the
// plain PyTorch version blindno_torch/ops/fno_layer.py up to summation order.
//
// Work at the main serving shape (B=4, C=12, H=W=76, m1=m2=32, K=2*m1=64), per layer,
// as this kernel does it (dense truncated DFTs):
//   rDFT along W   B*C*H*m2*W*4      = 35.5 MFLOP
//   +-DFT along H  B*C*K*m2*H*8      = 59.8 MFLOP
//   mode mix       B*C*C*K*m2*8      =  9.4 MFLOP
//   inverse H      B*C*H*m2*K*8      = 59.8 MFLOP
//   inverse W      B*C*H*W*m2*4      = 35.5 MFLOP
//   pointwise      B*C*C*H*W*2       =  6.7 MFLOP     total ~207 MFLOP
// The function needs far fewer: done as FFTs (5 n log2 n per complex, 2.5 n log2 n per
// real transform of n points) the four transforms take ~16 MFLOP, so with the mix and
// the pointwise term it is ~32 MFLOP, 0.5 us at 67 TFLOP/s (H100 SXM f32 outside the
// tensor cores, the published peak at 700 W). Its bytes (x 1.11 MB + y 1.11 MB + wr,wi
// 2.36 MB, read or written once) take 1.37 us at 3.35 TB/s: the layer's bound is the
// bytes. The dense products of this version alone cost 3.1 us of f32 arithmetic, more
// than that bound. chip_smoke.py computes the bound from its own shapes and prints it
// beside the measured time and the card's nvidia-smi name and power limit (PERF.md).
// Why two stages. The Pallas kernel keeps one batch element's whole (C, H, W) tile and
// its (C, 2*m1, m2) complex spectrum in VMEM. At the main shape those are 277 KB and
// 196 KB, more than the 227 KB of shared memory one H100 block can use, and one block
// per batch element would fill 4 of 132 SMs. So the chain is cut where the data
// dependence changes:
//   stage A  grid (B*Cin, m2/8): the forward transforms act on one input channel and
//            separate over the kept W-frequencies, so a block takes one (b, cin) plane
//            (staged in shared memory) and 8 frequency columns, and writes its slice of
//            the (2*m1, m2) complex spectrum to a scratch buffer (786 KB at the main
//            shape, which stays in L2).
//   stage B  grid (B*Cout, H/16): a block mixes all Cin spectra for one output channel
//            (the mix is cheap, so each row block redoes it), then runs the inverse H
//            transform for its 16 output rows and the inverse W transform with the
//            pointwise term, bias and exact erf gelu fused into the store.
// Two launches per layer on the caller's stream, no synchronisation, no allocation.
// No tensor cores or TMA yet: this version is the correct, simple one.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using blindno::allow_smem;
using blindno::kMaxDevices;
using blindno::kMaxSmem;

constexpr int kThreads = 256;
constexpr int kModeChunk = 8;    // stage A: kept W-frequencies per block
constexpr int kRowChunk = 16;    // stage B: output rows per block

// Stage A: x[b, c] (H, W) -> spectrum[b, c] (K, m2) columns [m0, m0 + mc).
__global__ void __launch_bounds__(kThreads) forward_transform(
    const float* __restrict__ x,                                      // (B, C, H, W)
    const float* __restrict__ fyre, const float* __restrict__ fyim,   // (W, m2)
    const float* __restrict__ fxre, const float* __restrict__ fxim,   // (H, K)
    float* __restrict__ spec_r, float* __restrict__ spec_i,           // (B, C, K, m2)
    int H, int W, int K, int m2) {
  extern __shared__ float smem[];
  float* xs = smem;                      // H * W
  float* yr = xs + H * W;                // H * kModeChunk
  float* yi = yr + H * kModeChunk;
  const size_t plane = blockIdx.x;       // b * C + c
  const int m0 = blockIdx.y * kModeChunk;
  const int mc = min(kModeChunk, m2 - m0);

  const float* xp = x + plane * H * W;
  for (int i = threadIdx.x; i < H * W; i += blockDim.x) xs[i] = xp[i];
  __syncthreads();

  // truncated rDFT along W (real input)
  for (int i = threadIdx.x; i < H * mc; i += blockDim.x) {
    const int h = i / mc, j = i % mc, m = m0 + j;
    const float* row = xs + h * W;
    float ar = 0.f, ai = 0.f;
    for (int w = 0; w < W; ++w) {
      const float v = row[w];
      ar = fmaf(v, __ldg(fyre + w * m2 + m), ar);
      ai = fmaf(v, __ldg(fyim + w * m2 + m), ai);
    }
    yr[h * kModeChunk + j] = ar;
    yi[h * kModeChunk + j] = ai;
  }
  __syncthreads();

  // +/- block DFT along H (complex input)
  float* sr = spec_r + plane * K * m2;
  float* si = spec_i + plane * K * m2;
  for (int i = threadIdx.x; i < K * mc; i += blockDim.x) {
    const int k = i / mc, j = i % mc;
    float ar = 0.f, ai = 0.f;
    for (int h = 0; h < H; ++h) {
      const float cr = __ldg(fxre + h * K + k), ci = __ldg(fxim + h * K + k);
      const float vr = yr[h * kModeChunk + j], vi = yi[h * kModeChunk + j];
      ar = fmaf(cr, vr, fmaf(-ci, vi, ar));
      ai = fmaf(ci, vr, fmaf(cr, vi, ai));
    }
    sr[k * m2 + m0 + j] = ar;
    si[k * m2 + m0 + j] = ai;
  }
}

// Stage B: mix Cin spectra into output channel o, inverse transforms for rows
// [h0, h0 + hc), epilogue. kEpilogue: 0 spectral only, 1 + pointwise + bias, 2 + gelu.
template <int kEpilogue>
__global__ void __launch_bounds__(kThreads) inverse_transform(
    const float* __restrict__ spec_r, const float* __restrict__ spec_i,  // (B, Cin, K, m2)
    const float* __restrict__ wr, const float* __restrict__ wi,          // (Cin, Cout, K, m2)
    const float* __restrict__ gxre, const float* __restrict__ gxim,      // (K, H)
    const float* __restrict__ gyre, const float* __restrict__ gyim,      // (m2, W)
    const float* __restrict__ x,                                         // (B, Cin, H, W)
    const float* __restrict__ pk, int pk_si, int pk_so,                  // (Cin, Cout) strided
    const float* __restrict__ pb,                                        // (Cout,)
    float* __restrict__ out,                                             // (B, Cout, H, W)
    int Cin, int Cout, int H, int W, int K, int m2) {
  extern __shared__ float smem[];
  const int km = K * m2;
  float* mr = smem;                      // K * m2
  float* mi = mr + km;
  float* zr = mi + km;                   // kRowChunk * m2
  float* zi = zr + kRowChunk * m2;
  const int b = blockIdx.x / Cout, o = blockIdx.x % Cout;
  const int h0 = blockIdx.y * kRowChunk;
  const int hc = min(kRowChunk, H - h0);

  // per-mode complex channel mix
  for (int i = threadIdx.x; i < km; i += blockDim.x) {
    float ar = 0.f, ai = 0.f;
    for (int c = 0; c < Cin; ++c) {
      const size_t s = (size_t(b) * Cin + c) * km + i;
      const size_t q = (size_t(c) * Cout + o) * km + i;
      const float xr = spec_r[s], xi = spec_i[s];
      const float ur = __ldg(wr + q), ui = __ldg(wi + q);
      ar = fmaf(xr, ur, fmaf(-xi, ui, ar));
      ai = fmaf(xr, ui, fmaf(xi, ur, ai));
    }
    mr[i] = ar;
    mi[i] = ai;
  }
  __syncthreads();

  // inverse +/- DFT along H for this block's rows
  for (int i = threadIdx.x; i < hc * m2; i += blockDim.x) {
    const int r = i / m2, m = i % m2, h = h0 + r;
    float ar = 0.f, ai = 0.f;
    for (int k = 0; k < K; ++k) {
      const float cr = __ldg(gxre + k * H + h), ci = __ldg(gxim + k * H + h);
      const float vr = mr[k * m2 + m], vi = mi[k * m2 + m];
      ar = fmaf(vr, cr, fmaf(-vi, ci, ar));
      ai = fmaf(vr, ci, fmaf(vi, cr, ai));
    }
    zr[r * m2 + m] = ar;
    zi[r * m2 + m] = ai;
  }
  __syncthreads();

  // inverse rDFT along W (real part), then the epilogue
  const size_t hw = size_t(H) * W;
  for (int i = threadIdx.x; i < hc * W; i += blockDim.x) {
    const int r = i / W, w = i % W, h = h0 + r;
    float acc = 0.f;
    for (int m = 0; m < m2; ++m) {
      acc = fmaf(zr[r * m2 + m], __ldg(gyre + m * W + w), acc);
      acc = fmaf(zi[r * m2 + m], __ldg(gyim + m * W + w), acc);
    }
    if (kEpilogue >= 1) {
      const float* xp = x + size_t(b) * Cin * hw + size_t(h) * W + w;
      float p = 0.f;
      for (int c = 0; c < Cin; ++c) p = fmaf(xp[c * hw], __ldg(pk + c * pk_si + o * pk_so), p);
      acc += p + __ldg(pb + o);
    }
    if (kEpilogue == 2) acc = 0.5f * acc * (1.f + erff(acc * 0.70710678118654752f));
    out[(size_t(b) * Cout + o) * hw + size_t(h) * W + w] = acc;
  }
}

template <int kEpilogue>
cudaError_t launch_inverse(dim3 grid, size_t smem, int device, cudaStream_t stream,
                           const float* spec_r, const float* spec_i, const float* wr,
                           const float* wi, const float* gxre, const float* gxim,
                           const float* gyre, const float* gyim, const float* x,
                           const float* pk, int pk_si, int pk_so, const float* pb, float* out,
                           int Cin, int Cout, int H, int W, int K, int m2) {
  static bool raised[kMaxDevices] = {};
  cudaError_t err = allow_smem(inverse_transform<kEpilogue>, smem, device, raised);
  if (err != cudaSuccess) return err;
  inverse_transform<kEpilogue><<<grid, kThreads, smem, stream>>>(
      spec_r, spec_i, wr, wi, gxre, gxim, gyre, gyim, x, pk, pk_si, pk_so, pb, out,
      Cin, Cout, H, W, K, m2);
  return cudaGetLastError();
}

// Both launches of one layer; `device` is current.
cudaError_t launch_layer(const float* x, const float* fyre, const float* fyim,
                         const float* fxre, const float* fxim, const float* gxre,
                         const float* gxim, const float* gyre, const float* gyim,
                         const float* wr, const float* wi, const float* pk, int pk_si,
                         int pk_so, const float* pb, float* spec, float* out, int B, int Cin,
                         int Cout, int H, int W, int m1, int m2, int epilogue, int device,
                         cudaStream_t s) {
  const int K = 2 * m1;
  const size_t smem_a = (size_t(H) * W + 2 * size_t(H) * kModeChunk) * sizeof(float);
  const size_t smem_b = (2 * size_t(K) * m2 + 2 * size_t(kRowChunk) * m2) * sizeof(float);
  if (smem_a > kMaxSmem || smem_b > kMaxSmem) return cudaErrorInvalidValue;
  float* spec_r = spec;
  float* spec_i = spec + size_t(B) * Cin * K * m2;

  static bool raised[kMaxDevices] = {};
  cudaError_t err = allow_smem(forward_transform, smem_a, device, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid_a(B * Cin, (m2 + kModeChunk - 1) / kModeChunk);
  forward_transform<<<grid_a, kThreads, smem_a, s>>>(x, fyre, fyim, fxre, fxim, spec_r,
                                                     spec_i, H, W, K, m2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid_b(B * Cout, (H + kRowChunk - 1) / kRowChunk);
#define FNO2D_LAUNCH(E)                                                                 \
  launch_inverse<E>(grid_b, smem_b, device, s, spec_r, spec_i, wr, wi, gxre, gxim, gyre, \
                    gyim, x, pk, pk_si, pk_so, pb, out, Cin, Cout, H, W, K, m2)
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
// pointwise term and bias, 2 also applies the exact gelu (fno2d_layer). `spec` is
// caller-allocated scratch of 2 * B * Cin * 2*m1 * m2 floats (real plane, then
// imaginary). The launches go to `device` on `stream`; the calling thread's current
// device is the same on return. Returns the CUDA error code (0 on success; the text is
// blindno_error_string's).
int fno2d_layer_forward(const float* x, const float* fyre, const float* fyim,
                        const float* fxre, const float* fxim, const float* gxre,
                        const float* gxim, const float* gyre, const float* gyim,
                        const float* wr, const float* wi, const float* pk, int pk_si,
                        int pk_so, const float* pb, float* spec, float* out, int B, int Cin,
                        int Cout, int H, int W, int m1, int m2, int epilogue, int device,
                        void* stream) {
  if (epilogue < 0 || epilogue > 2) return cudaErrorInvalidValue;
  return blindno::on_device(device, [&] {
    return launch_layer(x, fyre, fyim, fxre, fxim, gxre, gxim, gyre, gyim, wr, wi, pk,
                        pk_si, pk_so, pb, spec, out, B, Cin, Cout, H, W, m1, m2, epilogue,
                        device, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
