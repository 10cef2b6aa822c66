"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy written from the published equations, not from the
program: the SCORE embedding, the post-LN encoder and its head
(:mod:`.model`), the SU(2) and SU(4) drive2 Monte-Carlo propagators and
their fidelities (:mod:`.su2`, :mod:`.su4`), the KAK input tokens
(:mod:`.kak`), and the sharp loss, the global-norm clip and Adam
(:mod:`.train`).  Nothing here imports the program, JAX or the JAX package,
and nothing takes what the program made: the benchmark hands the same
inputs and weights to both sides, and the reference works out again what
the program derives from them.

Every function takes a ``precision``: ``"f32"`` (TF32 off), ``"tf32"``,
``"bf16"`` or ``"fp8"``.  The configured one is the reference; the one
below it is the control that a sound comparison must reject.
"""

import contextlib

import torch

PRECISIONS = ("f32", "tf32", "bf16", "fp8")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 on for ``"tf32"`` and off otherwise, restored on exit."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; want one of {PRECISIONS}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def elementwise_dtype(precision: str) -> torch.dtype:
    """The dtype the Monte-Carlo arithmetic runs in: bf16 for the controls
    below f32 elementwise work, f32 otherwise."""
    return torch.bfloat16 if precision in ("bf16", "fp8") else torch.float32
