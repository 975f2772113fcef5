"""Carry the JAX package's Flax parameters across to a port module's
``state_dict``.

Flax stores a module tree as nested dicts; the port's ``nn.Module``s use the
same submodule names, so the mapping is per leaf:

* Dense ``kernel`` (in, out)      -> Linear ``weight`` (out, in)
* Conv ``kernel`` (kh, kw, I, O)  -> Conv2d ``weight`` (O, I, kh, kw)
* LayerNorm ``scale``             -> ``weight``
* ``bias`` and bare parameters (e.g. ``rotary_freqs``) carry over as they are.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flax_to_state_dict(params, keep: set[str] | None = None) -> dict[str, torch.Tensor]:
    """Nested Flax params (dicts of array-likes) -> flat torch state dict.
    ``keep`` restricts the result to a module's own keys (Flax trees may
    hold heads a port module does not have yet)."""
    out: dict[str, torch.Tensor] = {}

    def walk(prefix: str, node):
        for name, val in node.items():
            key = f"{prefix}{name}"
            if isinstance(val, dict) or hasattr(val, "items"):
                walk(key + ".", val)
                continue
            arr = np.array(val, np.float32)  # a writable copy
            if name == "kernel":
                key = f"{prefix}weight"
                arr = arr.T if arr.ndim == 2 else np.transpose(arr, (3, 2, 0, 1))
            elif name == "scale":
                key = f"{prefix}weight"
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk("", params)
    if keep is not None:
        missing = keep - set(out)
        if missing:
            raise KeyError(f"Flax params lack {sorted(missing)[:8]}")
        out = {k: v for k, v in out.items() if k in keep}
    return out


def lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """Flax's default Dense and Conv kernel init, in place: a truncated
    normal of variance 1 / fan_in (fan_in = the product of every axis of the
    torch weight but the first)."""
    std = (1.0 / int(np.prod(w.shape[1:]))) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
