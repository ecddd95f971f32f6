"""The slice as a whole: a tiny f32 LLaMA (head_dim 128, 2 layers) takes 3
eager steps written the way a Paddle user writes them, through each
package's core surface on the same weights (carried across by
`weights.py`): ids made by `to_tensor`, the per-token cross entropy
reduced by the core's `mean`, `paddle.autograd.backward(loss)`,
`opt.step()`, `opt.clear_grad()`; then `paddle.grad` of the next loss
with respect to the final norm's weight, and a forward under
`paddle.no_grad()`. Bars: tests/test_torch_train_slice.py's (losses 1e-5
relative; each tensor's AdamW update within 1e-3 of its norm; gradients
1e-4 of their largest magnitude)."""
import numpy as np
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.weights import load_llama_state
from torch_core_cases import cpu_place  # noqa: F401
from torch_parity import jax_state

# head_dim 128: hidden 256 over 2 heads
CFG = dict(vocab=256, hidden=256, layers=2, heads=2, seq=64)
B, S, STEPS = 2, 64, 3


def _models(seed):
    P.seed(seed)
    jm = JaxLlama(JaxLlamaConfig.tiny(**CFG))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**CFG), device="cpu")
    load_llama_state(tm, jax_state(jm))
    return jm, tm


def _params(pkg, model):
    if pkg is P:
        return {n: np.asarray(p._data) for n, p in model.named_parameters()}
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _loss(pkg, F, model, x, y):
    """The mean of the per-token cross entropy, by the core's `mean`."""
    ids, labels = pkg.to_tensor(x), pkg.to_tensor(y)
    logits = model(ids)
    per_token = F.cross_entropy(pkg.reshape(logits, [-1, CFG["vocab"]]),
                                pkg.reshape(labels, [-1]),
                                reduction="none")
    return pkg.mean(per_token)


def _run(pkg, F, model, batches):
    opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                              parameters=model.parameters(),
                              weight_decay=0.01)
    losses = []
    for x, y in batches[:STEPS]:
        loss = _loss(pkg, F, model, x, y)
        pkg.autograd.backward(loss)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    x, y = batches[STEPS]
    norm_w = model.llama.norm.weight
    (g,) = pkg.grad(_loss(pkg, F, model, x, y), [norm_w])
    with pkg.no_grad():
        last = _loss(pkg, F, model, x, y)
    return losses, np.asarray(g if pkg is P else g.numpy()), float(last)


def test_three_eager_steps_through_the_core_match_the_reference(cpu_place):
    jm, tm = _models(21)
    before = _params(T, tm)
    rng = np.random.RandomState(21)
    batches = []
    for _ in range(STEPS + 1):
        x = rng.randint(0, CFG["vocab"], (B, S))
        batches.append((x, np.roll(x, -1, axis=1)))
    want, gw, lw = _run(P, JF, jm, batches)
    got, gt, lt = _run(T, TF, tm, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
    np.testing.assert_allclose(lt, lw, rtol=1e-5)
    assert np.abs(gt - gw).max() <= 1e-4 * np.abs(gw).max()
    ref = _params(P, jm)
    for n, p in tm.named_parameters():
        d_got = p.detach().numpy() - before[n]
        d_want = ref[n] - before[n]
        err = np.linalg.norm(d_got - d_want)
        assert err <= 1e-3 * max(np.linalg.norm(d_want), 1e-12), (n, err)
    # no gradient was left on any parameter by grad or no_grad
    assert all(p.grad is None for p in tm.parameters())
    assert torch.is_grad_enabled()
