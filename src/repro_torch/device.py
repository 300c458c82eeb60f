"""Device resolution shared by every public class and entry point."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  Raises when a CUDA device is asked
    for and none is present -- the port never drops to the CPU on its own;
    callers that want the plain CPU versions pass ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def not_in_slice(what: str, item: str) -> NotImplementedError:
    """The error raised for a reference option the port does not cover
    yet; ``item`` names the ROADMAP.md queue item that will port it."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md {item})")


def as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a contiguous float32 tensor on
    ``device``."""
    return torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()
