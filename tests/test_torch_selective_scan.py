"""K3 (selective_scan) in the port: its plain version against the JAX
package's oracle ``ref.selective_scan_ref`` over the sweep of
tests/test_kernels.py and ragged shapes, its final state against JAX's
associative scan, and the CPU → plain-version dispatch.  The CUDA kernel
against its plain version is tests/test_torch_cuda_mamba.py (no JAX there,
so it runs on the card's host).

The Pallas kernel itself is not run: it calls ``pl.load``, which the
installed JAX no longer has (tests/test_kernels.py's selective_scan cases
fail on it).  The tolerance is tests/test_kernels.py's float32 one (atol
1e-4, rtol 1e-3): the plain version is a sequential loop, the oracle a
log-depth associative scan, so the products are taken in other orders.
bf16 inputs are held to it too, since both sides read the same bf16 values
and compute in float32.
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.selective_scan import selective_scan_cuda

TOL = dict(atol=1e-4, rtol=1e-3)
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

SWEEP = [(1, 64, 128, 16), (2, 256, 512, 16), (1, 128, 256, 8)]


def inputs(B, S, d, N, seed):
    """tests/test_kernels.py's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xc = rng.standard_normal((B, S, d)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, d)) - 1)).astype(f32)
    Bm = rng.standard_normal((B, S, N)).astype(f32)
    Cm = rng.standard_normal((B, S, N)).astype(f32)
    A = (-np.exp(rng.standard_normal((d, N)) * 0.3)).astype(f32)
    D = rng.standard_normal(d).astype(f32)
    return xc, dt, Bm, Cm, A, D


def cast(arrays, dtype):
    """xc and dt in ``dtype`` (as the kernel takes them), the rest float32;
    the JAX side gets the same values as float32."""
    xc, dt, *rest = (torch.from_numpy(a) for a in arrays)
    port = [xc.to(TORCH[dtype]), dt.to(TORCH[dtype]), *rest]
    return port, [jnp.asarray(t.float().numpy()) for t in port]


def jax_final_state(xc, dt, Bm, Cm, A):
    """h_S of the oracle's associative scan (``ref.selective_scan_ref``'s
    dA, dBx and combine), which the oracle does not return."""
    dA = jnp.exp(dt[..., None] * A)
    dBx = (dt[..., None] * Bm[..., None, :]) * xc[..., None]

    def combine(a, b):
        (a1, b1), (a2, b2) = a, b
        return a1 * a2, a2 * b1 + b2

    _, h = jax.lax.associative_scan(combine, (dA, dBx), axis=1)
    return np.asarray(h[:, -1])


@pytest.mark.parametrize("B,S,d,N", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_oracle(B, S, d, N, dtype):
    port, jx = cast(inputs(B, S, d, N, seed=S + d), dtype)
    y, h = ref.selective_scan_ref(*port)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, S, d) and h.shape == (B, d, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jref.selective_scan_ref(*jx)), **TOL)
    np.testing.assert_allclose(h.numpy(), jax_final_state(*jx[:5]), **TOL)


@pytest.mark.parametrize("B,S,d,N", [(3, 77, 100, 16), (1, 1, 8, 4),
                                     (2, 300, 24, 32)])
def test_ragged_shapes_match_jax_oracle(B, S, d, N):
    port, jx = cast(inputs(B, S, d, N, seed=d), "float32")
    y, h = ref.selective_scan_ref(*port)
    np.testing.assert_allclose(y.numpy(), np.asarray(
        jref.selective_scan_ref(*jx)), **TOL)
    np.testing.assert_allclose(h.numpy(), jax_final_state(*jx[:5]), **TOL)


def test_state_carries_across_a_split():
    """tests/test_kernels.py's carry check, for the plain version: the
    second half scanned from the first half's final state equals the
    second half of one scan (the state enters as x·0 + h·exp(dt·A))."""
    port, _ = cast(inputs(1, 256, 128, 16, seed=3), "float32")
    xc, dt, Bm, Cm, A, D = port
    y, h = ref.selective_scan_ref(*port)
    y1, h1 = ref.selective_scan_ref(xc[:, :128], dt[:, :128], Bm[:, :128],
                                    Cm[:, :128], A, D)
    # carry h1 by hand through the second half
    hh = h1
    ys = []
    for t in range(128, 256):
        hh = torch.exp(dt[:, t, :, None] * A) * hh \
            + (dt[:, t, :, None] * Bm[:, t, None, :]) * xc[:, t, :, None]
        ys.append((hh * Cm[:, t, None, :]).sum(-1) + D * xc[:, t])
    torch.testing.assert_close(y[:, :128], y1, rtol=0, atol=0)
    torch.testing.assert_close(y[:, 128:], torch.stack(ys, 1), rtol=0,
                               atol=0)
    torch.testing.assert_close(h, hh, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version():
    port, _ = cast(inputs(2, 40, 64, 16, seed=1), "float32")
    before = selective_scan_cuda.launches
    y, h = ops.selective_scan(*port)
    assert selective_scan_cuda.launches == before
    want_y, want_h = ref.selective_scan_ref(*port)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


def test_the_kernel_wrapper_refuses_cpu_tensors():
    port, _ = cast(inputs(1, 8, 64, 16, seed=2), "float32")
    before = selective_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_cuda(*port)
    assert selective_scan_cuda.launches == before
