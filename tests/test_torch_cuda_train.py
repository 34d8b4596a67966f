"""The LLM training path on an NVIDIA card: K2's and K3's autograd
functions against autograd through their plain versions, the kernels
launched without a graph under ``torch.inference_mode()``, reduced
configurations' loss, gradients and FL rounds on the card against the CPU,
and xLSTM generation on the card against the CPU.

Every test here is marked ``cuda`` and skips where there is no card.  This
file imports neither JAX nor the JAX package, so it runs on a host that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

Tolerances: the functions' forwards at tests/test_kernels.py's (fp32 2e-5,
bf16 3e-2 for K2; atol 1e-4, rtol 1e-3 for K3), their gradients equal to
the plain versions' (the backward recomputes the plain version on the same
inputs); card against CPU in float32 with TF32 off at rtol 1e-4, atol 5e-5
(the products summed in other orders, over up to eight layers, as
tests/test_torch_transformer.py holds reduced Jamba's logits).
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)

import pytest
import torch

from repro_torch import configs
from repro_torch import random as jr
from repro_torch.fl import distributed as D
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.selective_scan import selective_scan_cuda
from repro_torch.launch import generate

pytestmark = pytest.mark.cuda

ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
            torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
SCAN_TOL = dict(atol=1e-4, rtol=1e-3)
CPU_TOL = dict(rtol=1e-4, atol=5e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,S,H,KV,hd,dtype,window", [
    (2, 64, 32, 8, 64, torch.bfloat16, None),
    (2, 130, 8, 2, 128, torch.bfloat16, 32),
    (2, 16, 4, 1, 64, torch.float32, None)])
def test_flash_attention_function_gradients(card, B, S, H, KV, hd, dtype,
                                            window):
    gen = torch.Generator(device=card).manual_seed(S)
    q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=card)
               .to(dtype).requires_grad_() for n in (H, KV, KV))
    g = torch.randn(B, S, H, hd, generator=gen, device=card).to(dtype)
    before = flash_attention_cuda.launches
    out = ops.flash_attention(q, k, v, window=window)
    assert flash_attention_cuda.launches == before + 1
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), g)
    plain = ref.flash_attention_ref(q, k, v, window=window)
    want = torch.autograd.grad(plain, (q, k, v), g)
    torch.testing.assert_close(out.float(), plain.float(), **ATTN_TOL[dtype])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("B,S,d,N", [(2, 16, 512, 16), (1, 33, 96, 8)])
def test_selective_scan_function_gradients(card, B, S, d, N):
    gen = torch.Generator(device=card).manual_seed(S)
    xc = torch.randn(B, S, d, generator=gen, device=card)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, d, generator=gen, device=card) - 1)
    Bm, Cm = (torch.randn(B, S, N, generator=gen, device=card)
              for _ in range(2))
    A = -torch.exp(torch.randn(d, N, generator=gen, device=card) * 0.3)
    D_ = torch.randn(d, generator=gen, device=card)
    inputs = tuple(t.requires_grad_() for t in (xc, dt, Bm, Cm, A, D_))
    gy = torch.randn(B, S, d, generator=gen, device=card)
    gh = torch.randn(B, d, N, generator=gen, device=card)
    before = selective_scan_cuda.launches
    y, h = ops.selective_scan(*inputs)
    assert selective_scan_cuda.launches == before + 1
    got = torch.autograd.grad((y, h), inputs, (gy, gh))
    wy, wh = ref.selective_scan_ref(*inputs)
    want = torch.autograd.grad((wy, wh), inputs, (gy, gh))
    torch.testing.assert_close(y, wy, **SCAN_TOL)
    torch.testing.assert_close(h, wh, **SCAN_TOL)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_inference_builds_no_graph(card):
    """Under ``torch.inference_mode()`` (and for inputs that need no
    gradient) the kernels run directly: no autograd node, one launch each."""
    q = torch.randn(1, 32, 4, 64, device=card, requires_grad=True)
    k = torch.randn(1, 32, 2, 64, device=card)
    before = flash_attention_cuda.launches
    with torch.inference_mode():
        out = ops.flash_attention(q, k, k)
    assert out.grad_fn is None
    assert ops.flash_attention(q.detach(), k, k).grad_fn is None
    assert flash_attention_cuda.launches == before + 2


@pytest.mark.parametrize("name", ["llama3.2-1b", "jamba-1.5-large-398b",
                                  "xlstm-125m"])
def test_fl_rounds_on_the_card_equal_the_cpus(card, name):
    """Reduced float32 configuration, K 2: ``loss_and_grads`` and one
    replica round (2 local steps, 2 micro-batches) on the card against the
    CPU from the same state and batch."""
    cfg = configs.get(name).reduced()
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 4, 16), generator=gen,
                         dtype=torch.int32)
    mask = torch.tensor([0.0, 1.0])
    out = {}
    for dev in (card, torch.device("cpu")):
        state = D.init_dist_state(jr.PRNGKey(1), cfg, 2, device=dev)
        value, grads = D.loss_and_grads(cfg, state.global_params,
                                        {"tokens": toks[0].to(dev)})
        new, m = D.fl_train_step(state, cfg, {"tokens": toks.to(dev)},
                                 mask.to(dev), 0.01, local_iters=2,
                                 micro_batches=2)
        out[dev.type] = (value, grads, new, m)
    (vc, gc, nc, mc), (vp, gp, np_, mp) = out["cuda"], out["cpu"]
    torch.testing.assert_close(vc.cpu(), vp, **CPU_TOL)
    for a, b in zip(gc, gp):
        torch.testing.assert_close(a.cpu(), b, **CPU_TOL)
    assert int(mc["participants"]) == int(mp["participants"]) == 1
    for field in ("global_params", "client_params", "anchor_params"):
        for a, b in zip(getattr(nc, field), getattr(np_, field)):
            torch.testing.assert_close(a.cpu(), b, **CPU_TOL)


def test_xlstm_generation_on_the_card_equals_the_cpus(card):
    """Reduced xLSTM-125M in float32: the card's greedy tokens are the
    CPU's."""
    cfg = configs.get("xlstm-125m").reduced()
    got = generate.generate(cfg, batch=2, prompt_len=24, new_tokens=8,
                            device=card)
    want = generate.generate(cfg, batch=2, prompt_len=24, new_tokens=8,
                             device="cpu")
    assert torch.equal(got["tokens"], want["tokens"])
