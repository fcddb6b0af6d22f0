"""Memory and size debugging helpers (counterpart of ``blindno/utils/debug.py``, the
reference's ``debug_tools.py``): a human-readable byte count, the parameter count and
size of a module or a state dict, and a device-memory debugger over
``torch.cuda.memory_allocated``."""
from __future__ import annotations

import math

import torch

from blindno_torch import default_device


def format_tensor_size(nbytes: float) -> str:
    """Human-readable byte count, binary units (``debug_tools.py:format_tensor_size``)."""
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(nbytes) < 1024.0:
            return f"{nbytes:.2f} {unit}"
        nbytes /= 1024.0
    return f"{nbytes:.2f} PiB"


def _tensors(tree):
    """A module's parameters, or the values of a state dict."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    return [v for v in tree.values() if isinstance(v, torch.Tensor)]


def param_count(tree) -> int:
    """The elements of a module's parameters, or of a state dict's tensors."""
    return sum(math.prod(t.shape) for t in _tensors(tree))


def print_size(tree, name: str = "model") -> int:
    """Print the parameter count and bytes, as the reference's ``print_size`` helpers
    (``1d_FPE/DeepONetModules.py:115-125``) do; returns the count."""
    n = param_count(tree)
    nbytes = sum(math.prod(t.shape) * t.element_size() for t in _tensors(tree))
    print(f"Total number of {name} parameters: {n} (~{format_tensor_size(nbytes)})")
    return n


class DeviceMemoryDebugger:
    """The reference's ``CudaMemoryDebugger`` (``debug_tools.py:39-103``): logs the
    memory allocated on ``device`` (CUDA unless the caller passes another) and its change
    since the last checkpoint. On a device without a CUDA allocator the reading is 0."""

    def __init__(self, print_mem: bool = True, device=None):
        self.print_mem = print_mem
        self.device = default_device(device)
        self._last = self._current()

    def _current(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.memory_allocated(self.device))

    def print(self, label: str = "") -> int:
        cur = self._current()
        if self.print_mem:
            delta = cur - self._last
            print(f"[mem] {label}: {format_tensor_size(cur)} (delta {format_tensor_size(delta)})")
        self._last = cur
        return cur
