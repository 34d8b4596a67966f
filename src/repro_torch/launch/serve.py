"""Deprecated alias for :mod:`repro_torch.launch.generate`, as
``repro.launch.serve`` is for ``repro.launch.generate``.

The batched LLM decode demo is text generation, not the FL aggregation
front door, which is :mod:`repro_torch.serve`.  ``python -m
repro_torch.launch.serve`` keeps working: it forwards to
:func:`repro_torch.launch.generate.main` after a ``DeprecationWarning``.
"""
from __future__ import annotations

import warnings

from .generate import main as _generate_main


def main(argv=None):
    warnings.warn(
        "repro_torch.launch.serve is deprecated; the decode demo moved to "
        "repro_torch.launch.generate and the FL front door lives in "
        "repro_torch.serve",
        DeprecationWarning,
        stacklevel=2,
    )
    return _generate_main(argv)


if __name__ == "__main__":
    main()
