"""What the timed path's modules put out, read while the check's call runs:
a global forward hook, so that nothing of the program is patched."""
from __future__ import annotations

import torch


class EvalOutputs:
    """While open, ``read(output)`` of each eval-mode forward of a
    ``module_type`` module, in call order."""

    def __init__(self, module_type, read=lambda out: out):
        self.module_type, self.read = module_type, read
        self.outputs = []

    def _hook(self, module, args, out):
        if isinstance(module, self.module_type) and not module.training:
            self.outputs.append(self.read(out).detach())

    def __enter__(self):
        self._handle = torch.nn.modules.module.register_module_forward_hook(self._hook)
        return self

    def __exit__(self, *exc):
        self._handle.remove()
