"""Utilities of the port: the nvcc build and ctypes binding of the
CUDA sources, the host-to-device loader, the device choice, and the
benchmark's errors, timing and report."""
