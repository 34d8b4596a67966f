"""Cost-probe mode for the dry run's accounting.  Counterpart of
``repro.models.costmode``: the same flag, read where the port has the same
choice to make.

JAX needs the flag because XLA's cost analysis counts a ``while``/``scan``
body once whatever its trip count: its dry run lowers 1- and 2-super-block
probes with the layer stack unrolled and the sequence mixers unchunked, and
rebuilds a total as ``M(1) + (R − 1)·(M(2) − M(1))``.  The port runs eagerly,
so ``FlopCounterMode`` counts every operation of every layer and the probes'
total equals the full-depth count; ``launch/dryrun.py`` still records the
probes, as JAX's does, and the tests hold that equality.

Where the flag is read:

* ``models/xlstm.py``: the mLSTM runs one chunk of S tokens instead of
  chunks of 256 (JAX ``xlstm.py:81``);
* ``models/transformer.py``: the sequence-parallel hint at super-block
  boundaries is not given, as JAX's unrolled cost-mode branch gives none.

It has nothing to switch where JAX reads it elsewhere: the port has no scan
over layers (JAX ``transformer.py:177``: its layers are a ``ModuleList``
run one after another), no chunked attention (JAX ``attention.py:94``:
full-sequence attention is K2, one op over the whole sequence) and no
chunked selective scan (JAX ``mamba.py:110``: K3 is one op over the whole
sequence).
"""
from __future__ import annotations

import contextlib

_COST_MODE = False


def cost_mode() -> bool:
    return _COST_MODE


@contextlib.contextmanager
def cost_probe():
    global _COST_MODE
    prev = _COST_MODE
    _COST_MODE = True
    try:
        yield
    finally:
        _COST_MODE = prev
