"""Bootstrap, placement, edge-set transfers and the peer-push kernel of
the reference program's path (``python -m tpu_p2p_torch``)."""
