"""tpu_p2p_torch — the PyTorch + CUDA port of ``tpu_p2p`` for NVIDIA
Hopper (H100).

A package of its own beside the JAX reference: it imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``tpu_p2p``. Module paths mirror
the reference's, so each counterpart sits in the same place. Every
module of the reference has its counterpart: the paged serving engine (``python -m tpu_p2p_torch serve``, the
KV-cache row-write kernel in ``csrc/kvcache.cu``), the single-card training loop
(``train``, three flash-attention kernels in
``csrc/flash_attention.cu``), and the reference program itself
(``python -m tpu_p2p_torch``: the all-pairs P2P matrix and the latency
line, with the peer-push kernel in ``csrc/p2p_dma.cu``), and the slices
after them (ROADMAP.md), among them the tick-IR pipeline schedules
(``models/schedule.py``; ``python -m tpu_p2p_torch zb``), observability
and health (``obs``), and the topology engine (``topo``).
"""
