"""Local SGD of the MLP's client rows: the plain version of the kernel
(``repro_torch.kernels.ref.mlp_local_sgd_ref``) against the autograd loop
of ``make_local_train`` on the same rows and batches, the inputs the
wrapper refuses (it raises before it touches the card, so they run here),
and the engine's route: the kernel only for plain SGD of the MLP's
CUDA rows, the autograd loop for the CNN, momentum, Adam and CPU rows,
each call counted (``local_sgd.kernel`` / ``local_sgd.autograd``).

The kernel itself, and its launch plan (the library's), run on the card
only (``tests/test_torch_cuda.py``).
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)

import pytest
import torch

from repro_torch import random as jr
from repro_torch.fl.engine import make_local_train
from repro_torch.fl.state import ParamLayout
from repro_torch.kernels import mlp_sgd, ops, ref
from repro_torch.models.small import (cnn_loss, init_cnn, init_mlp,
                                      mlp_loss)
from repro_torch.obs.telemetry import get_telemetry
from repro_torch.optim import adam, momentum, sgd

MAIN = (784, 200, 10)


def rows_and_batches(dims, R, L, B, seed=0, pad=3.0):
    """``R`` rows near one initial MLP with padding ``pad``, and ``[R, L,
    B, D]`` inputs and ``[R, L, B]`` int32 labels."""
    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(jr.PRNGKey(seed), dims, device="cpu")
    layout = ParamLayout.of(params)
    rows = layout.flatten(params).expand(R, -1) \
        + 0.01 * torch.randn(R, layout.width, generator=gen)
    rows[:, layout.size:] = pad
    xb = torch.randn(R, L, B, dims[0], generator=gen)
    yb = torch.randint(0, dims[-1], (R, L, B), generator=gen,
                       dtype=torch.int32)
    return rows, xb, yb, layout


def counts():
    c = get_telemetry().counters
    return c.get("local_sgd.kernel", 0), c.get("local_sgd.autograd", 0)


@pytest.mark.parametrize("dims,R,L,B", [
    (MAIN, 3, 5, 10), (MAIN, 1, 1, 1), (MAIN, 2, 2, 32),
    ((16, 8, 3), 4, 3, 1), ((20, 12, 5), 3, 2, 7), ((64, 32, 10), 5, 0, 4)])
def test_plain_version_matches_the_autograd_loop(dims, R, L, B):
    rows, xb, yb, layout = rows_and_batches(dims, R, L, B)
    want = make_local_train(mlp_loss, sgd(0.05))(rows, xb, yb, layout)
    got = ref.mlp_local_sgd_ref(rows, xb, yb, 0.05, layout)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the padding is copied, whatever it holds
    assert torch.equal(got[:, layout.size:], rows[:, layout.size:])
    if L:
        assert not torch.equal(got[:, :layout.size], rows[:, :layout.size])
    else:
        assert torch.equal(got, rows) and got.data_ptr() != rows.data_ptr()


def test_plain_version_takes_each_gradient_at_the_steps_parameters():
    """A large step makes the order visible: dh from the pre-update W2 (as
    autograd) differs from dh from the updated W2 by far more than
    rounding."""
    rows, xb, yb, layout = rows_and_batches((16, 8, 3), 4, 1, 5)
    lr = 5.0
    want = make_local_train(mlp_loss, sgd(lr))(rows, xb, yb, layout)
    got = ref.mlp_local_sgd_ref(rows, xb, yb, lr, layout)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # W2 first, then dh from the new W2: a different W1
    (l1, l2) = layout.unflatten(rows.clone())
    x, y = xb[:, 0], yb[:, 0].long()
    h = torch.relu(x @ l1["w"] + l1["b"].unsqueeze(-2))
    p = torch.softmax(h @ l2["w"] + l2["b"].unsqueeze(-2), -1)
    dl = (p - torch.nn.functional.one_hot(y, 3)) / 5
    w2 = l2["w"] - lr * (h.transpose(-1, -2) @ dl)
    dh = torch.where(h <= 0, 0.0, dl @ w2.transpose(-1, -2))
    w1_late = l1["w"] - lr * (x.transpose(-1, -2) @ dh)
    w1_got = layout.unflatten(got)[0]["w"]
    assert (w1_late - w1_got).abs().max() > 1e-3


def test_ops_takes_the_plain_version_on_the_cpu():
    rows, xb, yb, layout = rows_and_batches((16, 8, 3), 3, 2, 4)
    assert torch.equal(ops.mlp_local_sgd(rows, xb, yb, 0.1, layout),
                       ref.mlp_local_sgd_ref(rows, xb, yb, 0.1, layout))


def test_sgd_states_its_lr_and_the_others_do_not():
    assert sgd(0.01).lr == 0.01
    assert momentum(0.01).lr is None
    assert adam(0.01).lr is None


@pytest.mark.parametrize("case", ["cnn", "momentum", "adam", "cpu",
                                  "no_steps"])
def test_route_takes_the_autograd_loop(case):
    tel = get_telemetry()
    tel.reset()
    if case == "cnn":
        params = init_cnn(jr.PRNGKey(0), widths=(4,), fc=8, device="cpu")
        layout = ParamLayout.of(params)
        rows = layout.flatten(params).expand(2, -1).contiguous()
        xb = torch.randn(2, 1, 3, 32, 32, 3)
        yb = torch.randint(0, 10, (2, 1, 3), dtype=torch.int32)
        train = make_local_train(cnn_loss, sgd(0.01))
    else:
        rows, xb, yb, layout = rows_and_batches(
            (16, 8, 3), 3, 0 if case == "no_steps" else 2, 4)
        opt = {"momentum": momentum(0.01), "adam": adam(0.01)}.get(
            case, sgd(0.01))
        train = make_local_train(mlp_loss, opt)
    out = train(rows, xb, yb, layout)
    out = train(out, xb, yb, layout)
    assert counts() == (0, 2)
    if case == "no_steps":
        assert out is rows


def test_route_would_take_the_kernel_for_the_mlps_card_rows():
    """What the route asks of the trainer: the MLP's loss declares one that
    takes the MLP's layouts and no other; the rows' device and dtype the
    route reads itself, so this host's CPU rows take the autograd loop."""
    fused = mlp_loss.fused_sgd
    assert fused.run is ops.mlp_local_sgd
    assert not hasattr(cnn_loss, "fused_sgd")
    rows, xb, yb, layout = rows_and_batches(MAIN, 2, 1, 10)
    assert fused.takes(layout)
    assert fused.takes(rows_and_batches((16, 8, 3), 1, 1, 1)[3])
    deep = ParamLayout.of(init_mlp(jr.PRNGKey(0), (16, 8, 8, 3),
                                   device="cpu"))
    assert not fused.takes(deep)
    get_telemetry().reset()
    make_local_train(mlp_loss, sgd(0.01))(rows, xb, yb, layout)
    assert counts() == (0, 1)


def misaligned(rows):
    """``rows`` copied to a contiguous tensor that starts 4 bytes past a
    16-byte boundary."""
    flat = torch.empty(rows.numel() + 4)
    skip = next(k for k in range(1, 5) if (flat.data_ptr() + 4 * k) % 16 == 4)
    out = flat[skip:skip + rows.numel()].view(rows.shape)
    out.copy_(rows)
    return out


@pytest.mark.parametrize("case,match", [
    ("int64_labels", "int32"), ("float64_rows", "float32"),
    ("strided_xb", "contiguous"), ("xb_width", "xb"), ("yb_rows", "yb"),
    ("row_width", "rows"), ("deep_layout", "layout"), ("cnn_layout", "layout"),
    ("misaligned_rows", "16 bytes"), ("cpu", "CUDA")])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """The wrapper raises on each input the kernel does not take, before it
    touches the card (so this runs here), and never falls back."""
    rows, xb, yb, layout = rows_and_batches((16, 8, 3), 3, 2, 4)
    if case == "int64_labels":
        yb = yb.long()
    elif case == "float64_rows":
        rows = rows.double()
    elif case == "strided_xb":
        xb = xb.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "xb_width":
        xb = xb[..., :15].contiguous()
    elif case == "yb_rows":
        yb = yb[:2].contiguous()
    elif case == "row_width":
        rows = torch.cat([rows, rows[:, :4]], 1)
    elif case == "deep_layout":
        layout = ParamLayout.of(init_mlp(jr.PRNGKey(0), (16, 8, 8, 3),
                                         device="cpu"))
    elif case == "cnn_layout":
        layout = ParamLayout.of(init_cnn(jr.PRNGKey(0), widths=(4,), fc=8,
                                         device="cpu"))
    elif case == "misaligned_rows":
        rows = misaligned(rows)
    assert match in mlp_sgd.refusal(rows, xb, yb, layout)
    before = mlp_sgd.mlp_local_sgd_cuda.launches
    with pytest.raises(ValueError, match=match):
        mlp_sgd.mlp_local_sgd_cuda(rows, xb, yb, 0.01, layout)
    assert mlp_sgd.mlp_local_sgd_cuda.launches == before


def test_widths_read_the_layout_and_refuse_others():
    params = init_mlp(jr.PRNGKey(0), device="cpu")
    assert mlp_sgd.widths(ParamLayout.of(params)) == MAIN
    deep = init_mlp(jr.PRNGKey(0), (16, 8, 8, 3), device="cpu")
    assert mlp_sgd.widths(ParamLayout.of(deep)) is None
    cnn = init_cnn(jr.PRNGKey(0), widths=(4,), fc=8, device="cpu")
    assert mlp_sgd.widths(ParamLayout.of(cnn)) is None
    rows, xb, yb, _ = rows_and_batches((16, 8, 3), 1, 1, 1)
    assert mlp_sgd.refusal(rows, xb, yb, ParamLayout.of(deep)).startswith(
        "not a one-hidden-layer MLP layout")
