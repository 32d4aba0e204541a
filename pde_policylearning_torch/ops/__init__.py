"""Tensor ops of the port: normalizers, factorized complex weights, the
spectral convolution and its corner-contraction kernel, padding and
resampling."""
