"""PyTorch/CUDA port of the Zen sparse-gradient synchronization stack.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``models/``, ``optim/``, ``data/``, ``train/``,
``launch/``, ``configs/``) and imports neither JAX nor ``repro``.  The three
Pallas kernels on the data-parallel Zen path are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, each with a plain PyTorch version beside it in
``kernels/ref.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without that argument they raise (:func:`resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Never falls back to the CPU: asking for CUDA (explicitly or by default)
    on a machine without a usable GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
