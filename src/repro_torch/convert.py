"""Carry the JAX package's data and state (as numpy arrays) into the port.

Both packages meet only through numpy: the reference hands over its arrays,
and these functions place them on the port's device as contiguous float32
tensors.  Later slices extend this module with LM parameters.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.problems import ERMProblem, LossName


def _f32(a, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def problem_from_numpy(X: np.ndarray, y: np.ndarray, lam: float,
                       loss: LossName = "hinge", smooth_gamma: float = 1.0,
                       device: DeviceLike = None) -> ERMProblem:
    """An ``ERMProblem`` over (X (n, d), y (n,)) on ``device`` (the card when
    None)."""
    device = resolve_device(device)
    return ERMProblem(_f32(X, device), _f32(y, device), float(lam), loss,
                      float(smooth_gamma))


def cocoa_state_from_numpy(X: np.ndarray, y: np.ndarray, a: np.ndarray,
                           w: np.ndarray, device: DeviceLike = None
                           ) -> Tuple[torch.Tensor, ...]:
    """CoCoA's shards and state (Xs (m, nl, d), ys (m, nl), a (m, nl),
    w (d,)) as float32 tensors on ``device`` (the card when None)."""
    device = resolve_device(device)
    return tuple(_f32(t, device) for t in (X, y, a, w))
