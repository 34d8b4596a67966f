"""K2 (flash_attention) on an NVIDIA card against its plain version, and a
reduced text generation on the card against the same run on the CPU.

Every test here is marked ``cuda`` and skips where there is no card.  This
file imports neither JAX nor the JAX package, so it runs on a host that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_attention.py

Tolerances are tests/test_kernels.py's: fp32 2e-5, bf16 3e-2.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.launch import generate

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def qkv(card, B, S, H, KV, hd, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(B, S, n, hd, generator=gen, device=card).to(dtype)
            for n in (H, KV, KV)]


def check(q, k, v, **kw):
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[q.dtype])


@pytest.mark.parametrize("B,S,H,KV,hd", [
    (1, 128, 2, 2, 64),      # MHA
    (2, 256, 4, 2, 64),      # GQA 2:1
    (1, 256, 8, 2, 128),     # GQA 4:1, wide head
    (1, 512, 4, 1, 64),      # MQA
    (1, 1000, 8, 2, 128),    # ragged last tile
    (3, 77, 4, 4, 64),
    (2, 1, 4, 2, 64),        # one token
    (2, 129, 8, 2, 64),      # one row past the 128-row query tile
    (2, 200, 8, 2, 128),     # S past the 128-key K/V tile, hd 128
    (1, 1000, 64, 8, 128),   # Jamba's G = 8 at hd 128
    (1, 300, 64, 8, 64),     # G = 8 at hd 64
    (8, 1000, 16, 4, 64),    # 1024 work items: more than the grid's blocks
    (8, 1000, 16, 4, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(card, B, S, H, KV, hd, dtype):
    check(*qkv(card, B, S, H, KV, hd, dtype, seed=S + H))


@pytest.mark.parametrize("window", [1, 7, 32, 100, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_window_and_noncausal(card, window, causal, dtype, hd):
    check(*qkv(card, 2, 300, 4, 2, hd, dtype, seed=window), causal=causal,
          window=window)
    check(*qkv(card, 1, 300, 4, 2, hd, dtype, seed=1), causal=causal)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [130, 1000])
def test_strided_views_are_read_in_place(card, hd, dtype, S):
    """q, k, v as views into one fused [B,S,H+2KV,hd] buffer (the bf16
    kernel's tensor maps take their strides)."""
    fused = torch.randn(2, S, 16, hd, device=card).to(dtype)
    q, k, v = fused[:, :, :8], fused[:, :, 8:12], fused[:, :, 12:]
    assert not q.is_contiguous()
    check(q, k, v)


def test_first_token_attends_self_only(card):
    q, k, v = qkv(card, 1, 128, 2, 2, 64, torch.float32, seed=13)
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out[0, 0], v[0, 0], atol=1e-5, rtol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    q, k, v = qkv(card, 1, 64, 4, 2, 64, torch.float32, seed=0)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q[..., :32].contiguous(),
                             k[..., :32].contiguous(),
                             v[..., :32].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="last dim"):
        flash_attention_cuda(q.transpose(2, 3).contiguous().transpose(2, 3),
                             k, v)
    with pytest.raises(ValueError, match="device"):
        flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(ValueError, match="window"):
        flash_attention_cuda(q, k, v, window=0)


def test_reduced_generate_on_the_card_matches_the_cpu(card):
    """float32 with TF32 off: the greedy tokens on the card are the CPU's."""
    argv = ["--arch", "llama3.2-1b", "--reduced", "--prompt-len", "200",
            "--new-tokens", "12"]
    before = flash_attention_cuda.launches
    got = generate.main(argv)
    assert flash_attention_cuda.launches == before + 2     # n_layers
    want = generate.main(argv + ["--device", "cpu"])
    assert torch.equal(got["tokens"], want["tokens"])
