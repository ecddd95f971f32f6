"""GradScaler (counterpart of `paddle_tpu/amp/grad_scaler.py`): dynamic
loss scaling with the reference's state machine.

The reference's `_unscale` reads `isfinite` back to the host once per
parameter. Here all gradients are unscaled on the device in one pass
(`torch._amp_foreach_non_finite_check_and_unscale_`, which multiplies
each by 1 / scale in f32 and raises one device flag on a non-finite
value) and the flag is read once a step. The scale stays a power of two
from a power-of-two start, so the multiply gives the reference's values
in every dtype.
"""
from __future__ import annotations

import torch


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def _unscale(self, optimizer):
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameter_list or ()
                 if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        dev = grads[0].device
        found = torch.zeros((), dtype=torch.float32, device=dev)
        inv = torch.full((), 1.0 / self._scale, dtype=torch.float32,
                         device=dev)
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            torch._amp_foreach_non_finite_check_and_unscale_(group, found,
                                                             inv)
        self._found_inf = bool(found.item())

    def step(self, optimizer):
        """Unscale the gradients; step the optimizer unless one of them is
        not finite; update the scale."""
        if not self._enable:
            optimizer.step()
            return
        self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, loss):
        loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)
