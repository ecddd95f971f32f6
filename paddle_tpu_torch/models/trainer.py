"""The training step (counterpart of `paddle_tpu/models/trainer.py`
`build_train_step` over `paddle_tpu/jit/api.py` `train_step`, single
device: no mesh, no pipeline, no gradient merge).

The JAX package compiles forward, loss, gradients and the optimizer update
into one XLA program; here the step runs eagerly in PyTorch (no
`torch.compile`): the model's forward, `model.compute_loss`, `backward()`,
the optimizer's update and the gradients cleared. The kernels on the path
(the flash-attention forward and backward passes and the RMSNorm forward
and backward) run under autograd.
"""
from __future__ import annotations


def build_train_step(model, optimizer):
    """step(input_ids, labels) -> loss, a detached 0-d tensor on the model's
    device; the loss is `model.compute_loss` (the dense cross entropy,
    averaged over every token)."""

    def step(input_ids, labels):
        model.train()
        loss = model.compute_loss(model(input_ids), labels)
        loss.backward()
        optimizer.step()
        optimizer.clear_grad()
        return loss.detach()

    return step
