"""Rendering ops: encoding, sampling, sorting, scalar math, and kernels."""
