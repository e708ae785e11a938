"""Observability and fault injection of the port: the deterministic
storage faults the durable checkpoint is graded on
(:mod:`tpu_p2p_torch.obs.faults`) and the Chrome-trace exporter behind
``serve --trace`` (:mod:`tpu_p2p_torch.obs.trace`)."""
