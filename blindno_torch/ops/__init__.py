"""Spectral ops: truncated DFT matrices, the plain FNO1d and FNO2d chains, and their CUDA
kernels."""
