"""GradScaler (counterpart of `paddle_tpu/amp/grad_scaler.py`): dynamic
loss scaling with the reference's state machine.

The reference's `_unscale` reads `isfinite` back to the host once per
parameter. Here all gradients are unscaled on the device in one pass
(`torch._amp_foreach_non_finite_check_and_unscale_`, which multiplies
each by 1 / scale in f32 and raises one device flag on a non-finite
value) and the flag is read once a step. The scale stays a power of two
from a power-of-two start, so the multiply gives the reference's values
in every dtype.

Under ZeRO (a `DygraphShardingOptimizer` whose gradients are this rank's
slices) the slices are unscaled, and the found-inf flag is all_reduced
(MAX) over the ZeRO axis (and "dp" where both are > 1) before it is read:
otherwise one rank would step and another skip, and their parameters
would drift apart. At pipeline degree > 1 each stage unscales its own
gradients and the flag is MAX-reduced over "pp" as well, so every stage
skips together.
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
        zero = getattr(optimizer, "_zero_engine", None)
        if zero is not None:
            grads = [g for g in zero.grad_slices() if g is not None]
        else:
            grads = [p.grad for p in optimizer._parameter_list or ()
                     if p.grad is not None]
        from ..distributed import mesh as _mesh

        axes = [ax for ax in ((zero.axis, zero.dp_axis) if zero is not None
                              else ()) if ax is not None]
        if _mesh.axis_size("pp") > 1:
            axes.append("pp")
        if not grads and not axes:
            self._found_inf = False
            return
        if grads:
            dev = grads[0].device
        elif zero is not None:
            dev = zero.buckets[0].device
        else:
            from ..distributed import env as _env

            dev = _env.device() or torch.device("cpu")
        found = torch.zeros((), dtype=torch.float32, device=dev)
        inv = torch.full((), 1.0 / self._scale, dtype=torch.float32,
                         device=dev)
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            torch._amp_foreach_non_finite_check_and_unscale_(group, found,
                                                             inv)
        if axes:
            from ..distributed import collective as _c

            for ax in axes:
                _c.all_reduce(found, op=_c.ReduceOp.MAX, group=ax)
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
