"""Subpackage of fourier_tpu_torch."""
