"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `cuda` marker and skips without an NVIDIA GPU.
This file imports neither JAX nor `paddle_tpu`, so it also runs where JAX is
not installed; on such a machine skip `tests/conftest.py` (which sets up
JAX):

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, in the working dtype: bf16 outputs differ by at most one
rounding of the output, one bf16 ulp (2^-7 relative) at the largest
magnitude; f32 outputs differ by summation order only (1e-5 relative).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import ServingEngine
from paddle_tpu_torch.kernels import paged_attention as tpa
from paddle_tpu_torch.kernels import rms_norm as trms
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.weights import load_llama_state

_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest -m cuda "
                    "--noconftest tests/test_torch_cuda.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    return err <= _TOL[dtype] * max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,cols", [(8, 4096), (1000, 4096), (3, 128),
                                       (5, 11008)])
def test_rms_norm_kernel_matches_plain(cuda_device, dtype, rows, cols):
    g = torch.Generator(device=cuda_device).manual_seed(rows + cols)
    x = (torch.randn(rows, cols, generator=g, device=cuda_device) * 2) \
        .to(dtype)
    w = torch.randn(cols, generator=g, device=cuda_device).to(dtype)
    n0 = trms.launches
    got = trms.rms_norm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert trms.launches == n0 + 1
    assert _close(got, trms.rms_norm_ref(x, w, 1e-6), dtype)


def _decode_case(dev, dtype, b, q_heads, kv_heads, d, page, pages_per_seq,
                 lens, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = b * pages_per_seq
    shape = (kv_heads, n_pages, page, d)
    k = torch.randn(shape, generator=g, device=dev).to(dtype)
    v = torch.randn(shape, generator=g, device=dev).to(dtype)
    q = torch.randn(b, q_heads, d, generator=g, device=dev).to(dtype)
    tables = torch.randperm(n_pages, generator=g, device=dev) \
        .reshape(b, pages_per_seq).to(torch.int32)
    return q, k, v, tables, torch.tensor(lens, dtype=torch.int32,
                                         device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_heads,kv_heads,d,page", [
    (32, 32, 128, 16), (32, 8, 128, 16), (4, 2, 64, 8), (16, 1, 128, 128),
    (4, 2, 32, 8)])
def test_paged_attention_kernel_matches_plain(cuda_device, dtype, q_heads,
                                              kv_heads, d, page):
    lens = (0, 1, 15, 16, 17, 300, 511, 512)
    args = _decode_case(cuda_device, dtype, len(lens), q_heads, kv_heads, d,
                        page, 512 // page, lens, seed=d + page)
    n0 = tpa.launches
    got = tpa.paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.launches == n0 + 1
    assert _close(got, tpa.paged_attention_ref(*args), dtype)
    assert not got[0].any()  # a ctx == 0 row writes zeros


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.randn(8, 256, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        trms.rms_norm(x[:, ::2], torch.ones(128, device=cuda_device))
    with pytest.raises(TypeError):
        trms.rms_norm(x.half(), torch.ones(256, device=cuda_device).half())
    args = _decode_case(cuda_device, torch.float32, 2, 4, 2, 96, 8, 4,
                        (3, 5))
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(*args)


@pytest.mark.cuda
def test_tiny_engine_greedy_streams_equal_on_cuda_and_cpu(cuda_device):
    cfg = LlamaConfig.tiny(vocab=256, hidden=128, layers=2, heads=4, seq=64)
    cfg.num_key_value_heads = 2
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
    gpu = LlamaForCausalLM(cfg, device=cuda_device)
    load_llama_state(gpu, {k: v.numpy() for k, v in cpu.state_dict().items()})
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, (n,)) for n in (5, 9, 17, 3)]
    streams = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        eng = ServingEngine(model, max_batch=3, max_seq_len=48, page_size=8,
                            device=dev)
        for p in prompts:
            eng.add_request(p, max_new_tokens=12)
        streams.append({f.request_id: f.output_ids.tolist()
                        for f in eng.run()})
    assert streams[0] == streams[1]
