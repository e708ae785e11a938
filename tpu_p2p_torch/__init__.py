"""tpu_p2p_torch — the PyTorch + CUDA port of ``tpu_p2p`` for NVIDIA
Hopper (H100).

A package of its own beside the JAX reference: it imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``tpu_p2p``. Module paths mirror
the reference's, so each counterpart sits in the same place. Ported so
far: the paged serving engine (``python -m tpu_p2p_torch serve``, two
KV-cache kernels in ``csrc/kvcache.cu``), the single-card training loop
(``train``, three flash-attention kernels in
``csrc/flash_attention.cu``), and the reference program itself
(``python -m tpu_p2p_torch``: the all-pairs P2P matrix and the latency
line, with the peer-push kernel in ``csrc/p2p_dma.cu``).
"""
