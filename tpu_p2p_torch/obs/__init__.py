"""Observability and fault injection of the port: so far the
deterministic storage faults the durable checkpoint is graded on
(:mod:`tpu_p2p_torch.obs.faults`)."""
