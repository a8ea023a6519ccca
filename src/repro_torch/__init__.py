"""PyTorch + CUDA port of the FedOSAA system, beside the JAX package ``repro``.

The JAX package is the reference; this package mirrors its layout
(``core/``, ``data/``, ``models/``, ``kernels/``, ``utils/``) so each module
has a counterpart of the same name there. It imports ``torch`` and numpy and
nothing of ``jax`` or ``repro``.

Device policy. Every entry point (``run_federated``, ``make_round_fn``,
``init_state``, the problem builders) takes ``device`` and defaults to
``"cuda"``. Without a card it raises, unless the caller passes
``device="cpu"``. On the CPU every kernel wrapper runs its plain PyTorch
version (``ref.py`` beside the kernel); on a CUDA tensor it launches the
hand-written kernel or raises — it never falls back.

TF32 is switched off for matmuls and cuDNN: the reference accumulates in
true f32/f64, and TF32 keeps about three decimal digits. bf16 products
accumulate in f32 with no reduced-precision reduction, as the reference's
bf16 products do.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

#: device every entry point uses unless the caller names another
DEFAULT_DEVICE = "cuda"


def resolve_device(device: "str | torch.device" = DEFAULT_DEVICE) -> torch.device:
    """The torch device an entry point runs on.

    Raises when a CUDA device is asked for and none is available: the port
    never moves to the CPU on its own (pass ``device="cpu"`` for that).
    ``"cuda"`` names the current card with its index (``cuda:0``), the
    device its tensors report, so that it compares equal to theirs.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    return dev
