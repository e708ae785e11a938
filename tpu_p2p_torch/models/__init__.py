"""Model layer of the port: the flagship LM config, params, forward,
train steps and decode steps; the pipelines (GPipe, the generic
residual-MLP stack) and the tick-IR schedules that run them
(``schedule.py``, ``flagship_1f1b.py``, ``zb_split.py``)."""
