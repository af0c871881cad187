"""The plain reference of the eval the benchmark times: one episode at a
time in float32 PyTorch (or, for the control, with every product's operands
rounded to float8), from the benchmark's own state dicts and images.  It
imports nothing of ``mft_tpu_torch``, ``mft_tpu`` or ``jax``; what it shares
with the port is the published recipe (reference ``finetune.py``,
``finetune_50.py``, ``methods/gnn.py``, ``methods/dampnet_full_class.py``)
and the port's documented conventions for drawing an episode's random
numbers, which are restated here."""
