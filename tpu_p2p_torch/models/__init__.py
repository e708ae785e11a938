"""Model layer of the port: the flagship LM config, params and the
dense decode step."""
