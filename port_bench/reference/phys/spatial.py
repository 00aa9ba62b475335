"""6D spatial-vector algebra (PyTorch twin of massive_marl_tpu/phys/spatial.py).

Motion vectors are [omega; v_O] and force vectors [tau_O; f], in the world
frame about one reference point.  Index 0:3 is the angular part, 3:6 the
linear part.
"""
from __future__ import annotations

import torch

from .maths import cross, mm, skew


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[w1;p1] x [w2;p2] = [w1 x w2 ; w1 x p2 + p1 x w2]."""
    w1, p1 = v[..., :3], v[..., 3:]
    w2, p2 = m[..., :3], m[..., 3:]
    return torch.cat([cross(w1, w2), cross(w1, p2) + cross(p1, w2)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """[w;p] x* [t;f] = [w x t + p x f ; w x f]."""
    w, p = v[..., :3], v[..., 3:]
    t, fo = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, t) + cross(p, fo), cross(w, fo)], dim=-1)


def spatial_inertia(mass: torch.Tensor, com: torch.Tensor,
                    inertia_com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the reference point.

    I_O = [[I_c - m cx cx,  m cx],
           [-m cx,          m 1 ]]   with cx = skew(com)."""
    cx = skew(com)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    top = torch.cat([inertia_com - m * mm(cx, cx), m * cx], dim=-1)
    bot = torch.cat([-m * cx, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)
