"""Plain reference of the particle step (paper Table 3, §7.2).

Per step every particle of both species moves ``x += v * dt`` (``v`` is
carried unchanged), the field moves ``y += dt * x`` (``x`` is carried
unchanged) and ``vmax`` is the NaN-ignoring max of the ions' ``v``.  So
after ``K`` steps ``x_K = x_0 + K v dt``; the reference takes that closed
form in float64, block by block.

The inputs make every one of those additions exact in float32 (see
:func:`quantize`): each component is a multiple of ``QUANTUM`` no larger
than ``CLAMP``, and ``dt`` is a power of two, so ``v dt`` is a multiple
of ``QUANTUM dt`` and so is every ``x_k``, which stays below ``2**24``
such units while ``K < exact_steps(dt)``.  A float32 program therefore
lands on the closed form bit for bit, whatever its order of operations
(fused or not), and :func:`off` counts the elements that do not: a sound
run reads 0, a run one step short reads about every element with
``v != 0``, and a bfloat16 one, whose 8 bits hold no sum of a position
and an increment, reads almost every element.
"""

from __future__ import annotations

import numpy as np
import torch

QUANTUM = 2.0 ** -5
CLAMP = 8.0
BLOCK = 1 << 22


def quantize(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded, in place, to a multiple of ``QUANTUM`` within
    ``[-CLAMP, CLAMP]`` (a N(0, 1) draw passes ``CLAMP`` with odds of
    about 1e-15)."""
    lim = CLAMP / QUANTUM
    return x.mul_(1 / QUANTUM).round_().clamp_(-lim, lim).mul_(QUANTUM)


def exact_steps(dt: float) -> int:
    """The steps after which ``x`` may leave float32's exact range: the
    largest ``K`` with ``CLAMP + K CLAMP dt < 2**24 QUANTUM dt``.  ``dt``
    has to be a power of two."""
    m, _ = np.frexp(dt)
    if m != 0.5:
        raise ValueError(f"dt = {dt} is no power of two: x += v dt "
                         f"would round")
    unit = QUANTUM * dt
    return int((2 ** 24 * unit - CLAMP) // (CLAMP * dt))


def components(storage: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """The ``(c, n)`` components of a record stored AoS ``(n, c)``, SoA
    ``(c, n)`` or AoSoA ``(n / tile, c, tile)``, told apart by shape."""
    if storage.dim() == 3 and storage.shape[1] == c \
            and storage.shape[0] * storage.shape[2] == n:
        return storage.permute(1, 0, 2).reshape(c, n)
    if tuple(storage.shape) == (n, c):
        return storage.t()
    if tuple(storage.shape) == (c, n):
        return storage
    raise ValueError(f"storage of shape {tuple(storage.shape)} is no "
                     f"layout of {n} records of {c} components")


def off(got: torch.Tensor, start: torch.Tensor, rate: torch.Tensor,
        dt: float, steps: int) -> int:
    """How many elements of ``got`` differ from ``start + steps * rate *
    dt`` (exact for the inputs of :func:`quantize` up to
    :func:`exact_steps`).  All three are ``(c, n)``."""
    if steps > exact_steps(dt):
        raise ValueError(f"{steps} steps leave float32's exact range "
                         f"({exact_steps(dt)} at dt = {dt})")
    count = 0
    for i in range(0, got.shape[1], BLOCK):
        want = start[:, i:i + BLOCK].double() \
            + steps * (rate[:, i:i + BLOCK].double() * dt)
        count += int((got[:, i:i + BLOCK].double() != want).sum())
    return count


def changed(got: torch.Tensor, want: torch.Tensor) -> int:
    """How many elements differ from ``want`` bit for bit (a carried
    field: it must come back as it went in)."""
    return int((got.contiguous().view(torch.int32)
                != want.contiguous().view(torch.int32)).sum())


def nan_ignoring_max(v: torch.Tensor) -> float:
    """``vmax``: the max over every non-NaN element of ``(c, n)``."""
    best = float("-inf")
    for i in range(0, v.shape[1], BLOCK):
        b = v[:, i:i + BLOCK]
        best = max(best, float(torch.where(torch.isnan(b), float("-inf"),
                                           b).max()))
    return best


def clock(steps: int, dt: float) -> np.ndarray:
    """The time at the start of each of ``steps`` steps, ``t`` advanced by
    one float32 addition of ``dt`` a step from 0."""
    incs = np.full(steps, np.float32(dt), np.float32)
    incs[0] = 0.0
    return np.add.accumulate(incs, dtype=np.float32).astype(np.float64)


def step_lower(start: dict, dt: float, steps: int, dtype) -> tuple:
    """The control: the reference put in the program's place, stepping
    ``x += v dt``, ``y += dt x`` and the clock in ``dtype`` (bfloat16 for
    the configuration's float32) from the ``(c, n)`` components of
    ``start``.  Returns each record's final components (as float32), the
    final ``vmax`` and the ``(t, vmax)`` of every step."""
    d = torch.tensor(dt, dtype=dtype, device=start["ions"].device)
    x = {s: start[s][:3].to(dtype) for s in ("ions", "electrons")}
    v = {s: start[s][3:].to(dtype) for s in ("ions", "electrons")}
    fx, fy = start["field"][:1].to(dtype), start["field"][1:].to(dtype)
    vmax = nan_ignoring_max(v["ions"])
    t, dt_host = torch.zeros((), dtype=dtype), torch.tensor(dt, dtype=dtype)
    log = np.empty((steps, 2))
    for k in range(steps):
        log[k] = (float(t), vmax)
        for s in x:
            x[s] = x[s] + v[s] * d
        fy = fy + d * fx
        t = t + dt_host
    got = {s: torch.cat([x[s], v[s]]).float() for s in x}
    got["field"] = torch.cat([fx, fy]).float()
    return got, vmax, log
