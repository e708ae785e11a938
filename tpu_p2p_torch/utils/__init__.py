"""Utilities of the port: the nvcc build and ctypes binding of the
CUDA sources, the host-to-device loader, and the device choice."""
