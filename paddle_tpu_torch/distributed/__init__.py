"""Counterpart of `paddle_tpu/distributed`: only `fleet.utils.recompute`
is ported (the single-card training step's activation recompute)."""
