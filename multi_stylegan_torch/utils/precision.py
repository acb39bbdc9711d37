"""The port's f32 precision: full f32 in cuDNN's convolutions and cuBLAS's
matmuls.

Torch runs f32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True; the matmul flag is False),
which keeps about three decimal digits.  The JAX package's f32 on the CPU,
the port's parity checks on the card and every measurement of the port were
taken with both flags off, so the CLIs pin them off before they build a
model.  The JAX CLIs have no flag for this, and neither do the port's.
"""

from __future__ import annotations

import torch


def pin_f32() -> None:
    """Turn TF32 off for cuDNN's convolutions and cuBLAS's matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
