"""gs2m_tpu_torch — the PyTorch + CUDA port of gs2m_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (core/, data/, ops/, models/, utils/,
apps/) module for module, so each port sits at the same relative path as
its reference. Plain tensor code is PyTorch; the Pallas TPU kernels become
CUDA C++ kernels under csrc/, built with nvcc at first use (_build.py).
Everything is float32 with int32 index tensors, on an explicit device.
"""

import torch

# Covariance projection, SSIM blurs and the PBR prefilter matmuls need true
# f32 (bf16/TF32 SSIM is numerically unbounded); the JAX package pins the
# same with jax_default_matmul_precision="highest".
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
# A training step is reproducible bit for bit, as the JAX package's is: cuDNN
# picks deterministic convolution algorithms (the SSIM blur's backward), and
# no autotuner choice changes them between runs. Float gathers with gradient
# go through ops/gather.py, whose backward uses no atomics.
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device entry points run on when the caller names none: the first
    CUDA card. Raises instead of carrying on on the CPU — a CPU run must be
    asked for explicitly (device="cpu")."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """None or 'cuda' -> default_device() (raises without a card); else that
    device. Every constructor that takes a `device` resolves it here."""
    if device is None or str(device) == "cuda":
        return default_device()
    return torch.device(device)
