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


#: ROADMAP.md queue 1 items that unported options wait for, by number and
#: title (the title keeps a message readable when the queue is renumbered)
ROADMAP_ITEMS = {
    6: "the remaining estimators",
    7: "the bf16 precision policy",
    8: "streaming",
    9: "serving and telemetry",
    10: "multi-device engines",
    12: "the rest of the LM stack",
    14: "context-parallel prefill",
}


def roadmap_item(item: int) -> str:
    """"ROADMAP.md queue 1 item N, <title>": how the port names the item
    that will port an option (in refusals and help texts)."""
    return f"ROADMAP.md queue 1 item {item}, {ROADMAP_ITEMS[item]}"


def not_in_slice(what: str, item: int) -> NotImplementedError:
    """The error raised for a reference option the port does not cover
    yet; ``item`` is the number of the ROADMAP.md queue 1 item that will
    port it, named in the message with its title."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet ({roadmap_item(item)})")


def tile_size(name: str, value) -> None:
    """Check a reference tile size the port accepts and ignores (its plans
    size their own tiles; the result is the same function whatever the
    value): ``None`` or a positive int, else ValueError."""
    if value is None:
        return
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ValueError(f"{name} must be a positive int, got {value!r}")


def no_switch(name: str, value) -> None:
    """Refuse a reference implementation switch (``use_pallas``,
    ``interpret``) other than ``None``: the port chooses the kernel or its
    plain version by the tensor's device."""
    if value is not None:
        raise ValueError(
            f"{name}={value!r}: repro_torch chooses the kernel or its plain "
            f"version by the tensor's device; pass a CPU tensor (or "
            f"device='cpu') for the plain version")


def as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a contiguous float32 tensor on
    ``device``."""
    return torch.as_tensor(x, dtype=torch.float32).to(device).contiguous()
