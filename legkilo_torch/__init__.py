"""legkilo_torch — the PyTorch/CUDA port of legkilo_tpu.

A second package beside ``legkilo_tpu`` (the JAX reference, which stays as
it is): the deferred odometry pipeline in PyTorch (the fused chain of the
main path and the per-point ``chain_impl="jax"`` path), with the two chain
kernels and the match, insert-moment, pose and plane-refit kernels written
by hand in CUDA C++ for Hopper (``csrc/``).
It imports ``torch`` and numpy and nothing of JAX or of the JAX package.

Entry points run on the card (``device="cuda"``) and raise when it is
absent; they run on the CPU only when the caller asks for ``"cpu"``, as the
CPU tests do.  On a CPU tensor each kernel wrapper runs its plain PyTorch
version instead of the kernel.
"""

import torch

__version__ = "0.1.0"

# Full fp32 everywhere, as legkilo_tpu/__init__.py pins for JAX: lower
# matmul precision (bf16-truncated dots) raised the sim ATE from 0.0058 m to
# 0.2205 m (docs/PERF_NOTES.md "Matmul precision").  TF32 keeps ~3 decimal
# digits, the same class of loss.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU.  Raises instead of falling back when CUDA is asked for and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
