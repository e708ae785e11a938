"""Ops of the port: RoPE and the hand-written KV-cache kernels."""
