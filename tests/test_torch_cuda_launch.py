"""The launch layer on an NVIDIA card: the dry run on a world of one rank
(a 1×1 mesh) predicts a program's argument bytes, FLOPs and peak
temporary bytes, and the same program run on the card, in a new process
whose allocator starts empty, agrees: argument bytes = the CUDA caching
allocator's, exactly (``dryrun.allocator_bytes``); FLOPs =
``FlopCounterMode``'s on the card, exactly (K2 counted by its formula);
peak measured over predicted inside ``dryrun.PEAK_RATIO_LIMIT``; the
outputs equal the same program's on plain tensors.  Reduced
Llama (bf16, hd 64 for K2) at prefill, decode against a full cache and a
training round at K 4, K2 launched through its op on DTensors.

Every test here is marked ``cuda`` and skips where there is no card.  This
file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_launch.py
"""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)

import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun as DR

pytestmark = pytest.mark.cuda

REDUCED = dict(layers=2, d_model=512, n_heads=8, n_kv_heads=2)
CFG = dataclasses.replace(configs.get("llama3.2-1b").reduced(**REDUCED),
                          dtype="bfloat16")
PROGRAMS = {"prefill": InputShape("p", 256, 4, "prefill"),
            "decode": InputShape("d", 288, 4, "decode"),
            "train": InputShape("t", 64, 8, "train")}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = DR.fresh_check_one_card("llama3.2-1b", PROGRAMS, clients=4,
                                  reduced=REDUCED, dtype="bfloat16")
    return out, sum(r["measured"]["k2_launches"] for r in out.values())


def test_k1_launches_once_in_the_training_round(card):
    """The round is ``fl_train_step`` itself: eq. 3 is one K1 launch over
    the bf16 row; prefill and decode launch none."""
    out, _ = card
    assert {tag: r["measured"]["k1_launches"] for tag, r in out.items()} \
        == {"prefill": 0, "decode": 0, "train": 1}


@pytest.mark.parametrize("tag", list(PROGRAMS))
def test_one_card_prediction_holds_on_the_card(card, tag):
    out, _ = card
    p, m = out[tag]["predicted"], out[tag]["measured"]
    assert m["allocated_args"] == p["memory"]["argument_allocated_bytes"]
    assert m["cost"]["flops"] == p["cost"]["flops"] > 0
    lo, hi = DR.PEAK_RATIO_LIMIT
    assert lo <= m["peak_temp_bytes"] / p["memory"]["temp_size_in_bytes"] \
        <= hi
    assert m["out"]["finite"] and m["plain"]["within"], m["plain"]
    assert 0 <= m["out"]["int_range"][0] <= m["out"]["int_range"][1] \
        < CFG.vocab


def test_k2_launches_through_its_op_on_dtensors(card):
    """Prefill (one launch a layer) and the K = 4 clients' forwards."""
    _, launches = card
    assert launches == CFG.n_layers * (1 + 4)
