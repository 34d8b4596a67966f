"""K3 (selective_scan) on an NVIDIA card against its plain version, and the
reduced Jamba stack (Mamba, attention and MoE layers) on the card against
the same weights on the CPU.

Every test here is marked ``cuda`` and skips where there is no card.  This
file imports neither JAX nor the JAX package, so it runs on a host that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mamba.py

The scan is held to tests/test_kernels.py's float32 tolerance (atol 1e-4,
rtol 1e-3), y and the final state alike, also for bf16 inputs: the kernel
and its plain version read the same bf16 values and both compute in
float32.  The stack's, rtol 1e-4 / atol 1e-4: float32 on both sides (TF32 off),
the sums taken in other orders by cuBLAS and the CPU's BLAS, and the scan's
by K3 (``dt·x`` first, ``exp2f``) and its plain version.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch import random as jr
from repro_torch.kernels import ops, ref
from repro_torch.kernels.selective_scan import selective_scan_cuda
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda

TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def scan_inputs(card, B, S, d, N, x_dtype, dt_dtype=None, seed=0):
    """tests/test_kernels.py's distributions: x, B, C normal, dt =
    softplus(normal − 1), A = −exp(0.3·normal), D normal."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=card)

    xc = randn(B, S, d).to(x_dtype)
    dt = torch.nn.functional.softplus(randn(B, S, d) - 1).to(
        dt_dtype or x_dtype)
    Bm, Cm = randn(B, S, N), randn(B, S, N)
    A = -torch.exp(randn(d, N) * 0.3)
    return xc, dt, Bm, Cm, A, randn(d)


def check(xc, dt, Bm, Cm, A, D):
    before = selective_scan_cuda.launches
    y, h = ops.selective_scan(xc, dt, Bm, Cm, A, D)
    torch.cuda.synchronize()
    assert selective_scan_cuda.launches == before + 1
    B, S, d = xc.shape
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, d) and h.shape == (B, d, Bm.shape[2])
    want_y, want_h = ref.selective_scan_ref(xc, dt, Bm, Cm, A, D)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(h, want_h, **TOL)


@pytest.mark.parametrize("B,S,d,N", [(1, 64, 128, 16), (2, 256, 512, 16),
                                     (1, 128, 256, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(card, B, S, d, N, dtype):
    check(*scan_inputs(card, B, S, d, N, dtype, seed=S + d))


@pytest.mark.parametrize("B,S,d,N", [
    (3, 77, 1000, 16),     # ragged S and d
    (1, 1, 130, 8),        # one step, a third block of 2 channels
    (2, 100, 300, 8),      # S across 4 staged chunks of 32
    (1, 33, 64, 16),       # one step into the second chunk
    (2, 70, 100, 16),      # d past the 64-channel block, odd rows of x
    (1, 65, 129, 8),       # one channel into a third block
])
@pytest.mark.parametrize("x_dtype,dt_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_ragged_shapes_and_final_state(card, B, S, d, N, x_dtype, dt_dtype):
    check(*scan_inputs(card, B, S, d, N, x_dtype, dt_dtype, seed=d))


def test_model_dtypes_and_strided_b_c(card):
    """The model's call: bf16 xc, fp32 dt, and B, C as column slices of
    one x_proj output, read through their strides."""
    xc, dt, _, _, A, D = scan_inputs(card, 2, 70, 256, 16, torch.bfloat16,
                                     torch.float32, seed=5)
    proj = torch.randn(2, 70, 16 + 2 * 16, device=card)
    _, Bm, Cm = proj.split([16, 16, 16], dim=-1)
    assert not Bm.is_contiguous()
    check(xc, dt, Bm, Cm, A, D)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    xc, dt, Bm, Cm, A, D = scan_inputs(card, 1, 8, 64, 16, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_cuda(*(t.cpu() for t in (xc, dt, Bm, Cm, A, D)))
    with pytest.raises(TypeError):
        selective_scan_cuda(xc.half(), dt, Bm, Cm, A, D)
    with pytest.raises(TypeError):
        selective_scan_cuda(xc, dt, Bm.bfloat16(), Cm, A, D)
    with pytest.raises(ValueError, match="state size"):
        selective_scan_cuda(xc, dt, Bm[..., :5], Cm[..., :5], A[:, :5], D)
    with pytest.raises(ValueError, match="last dim"):
        selective_scan_cuda(xc.transpose(1, 2).contiguous().transpose(1, 2),
                            dt, Bm, Cm, A, D)


def test_reduced_jamba_on_the_card_equals_the_cpu(card):
    """Forward, prefill and 6 decode steps of reduced Jamba (Mamba, one
    attention layer, MoE with 4 experts) in float32 from the same weights:
    K3 once per Mamba layer of the forward and of the prefill, greedy tokens
    equal, logits within the stack's tolerance."""
    cfg = configs.get("jamba-1.5-large-398b").reduced()
    n_mamba = sum(m == "mamba" for m, _ in cfg.layer_plan()) * cfg.n_repeats
    model = T.init_params(jr.PRNGKey(3), cfg, device=card)
    cpu = T.Transformer(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    toks = jr.randint(jr.PRNGKey(4), (2, 40), 0, cfg.vocab)

    def run(m, t):
        with torch.inference_mode():
            full, aux = T.forward(m, tokens=t)
            lg, caches = T.prefill(m, tokens=t[:, :34], capacity=40)
            steps = [lg]
            for i in range(34, 40):
                lg, caches = T.decode_step(m, t[:, i:i + 1], caches)
                steps.append(lg)
        return full.cpu(), aux.cpu(), torch.cat(steps, 1).cpu()

    before = selective_scan_cuda.launches
    got = run(model, toks.to(card))
    assert selective_scan_cuda.launches == before + 2 * n_mamba
    want = run(cpu, toks)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[2].argmax(-1), want[2].argmax(-1))


def test_decode_defaults_to_a_cache_per_mixer(card):
    cfg = dataclasses.replace(configs.get("jamba-1.5-large-398b").reduced(),
                              dtype="bfloat16")
    caches = T.init_caches(cfg, 2, 16)
    assert [type(c).__name__ for c in caches] == [
        "KVCache" if m == "attn" else "MambaCache"
        for m, _ in cfg.layer_plan()]
    assert all(c[0].device.type == "cuda" for c in caches)
