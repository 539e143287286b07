"""The particle check is exact at the step counts a run reaches: float32
stepping of the seed's inputs, fused or not, lands on the reference's
closed form bit for bit up to the top of its exact range, and a run one
step short of the count it reports reads every moving element off."""

from __future__ import annotations

import pytest
import torch

from .common import SEED

from bench.drivers import particles  # noqa: E402
from bench.reference import particles as ref  # noqa: E402

DT = 2.0 ** -7
N = 1024


def _start():
    gen = torch.Generator().manual_seed(SEED)
    return {k: ref.components(
        particles.storage(N, c, "AOS", gen, "cpu"), N, c)
        for k, c in particles.COMPONENTS.items()}


def _step(start, steps, fused):
    d = torch.tensor(DT, dtype=torch.float32)
    x = {s: start[s][:3].clone() for s in ("ions", "electrons")}
    y = start["field"][1:].clone()
    for _ in range(steps):
        for s in x:
            x[s] = torch.addcmul(x[s], start[s][3:], d) if fused \
                else x[s] + start[s][3:] * d
        y = torch.addcmul(y, start["field"][:1], d) if fused \
            else y + d * start["field"][:1]
    got = {s: torch.cat([x[s], start[s][3:]]) for s in x}
    got["field"] = torch.cat([start["field"][:1], y])
    return got


def test_exact_range():
    assert ref.exact_steps(DT) == 65408
    with pytest.raises(ValueError):
        ref.exact_steps(0.01)
    with pytest.raises(ValueError):
        ref.off(torch.zeros(1, 1), torch.zeros(1, 1), torch.zeros(1, 1),
                DT, 65409)


@pytest.mark.parametrize("fused", [False, True])
def test_float32_stepping_is_the_closed_form_to_the_range_top(fused):
    start = _start()
    steps = ref.exact_steps(DT)
    got = _step(start, steps, fused)
    vmax = ref.nan_ignoring_max(start["ions"][3:])
    nums = particles.numbers(got, start, vmax, None, DT, steps)
    assert nums == {"x_off": 0, "y_off": 0, "carried_changed": 0,
                    "vmax_off": 0}


@pytest.mark.parametrize("steps", [1200, 20_000, 65_408])
def test_one_step_short_is_seen(steps):
    start = _start()
    got = _step(start, 1, fused=False)
    # the closed form of steps - 1 steps, a float32 run one step short
    for s in ("ions", "electrons"):
        got[s][:3] = (start[s][:3].double()
                      + (steps - 1) * (start[s][3:].double() * DT)).float()
    got["field"][1:] = (start["field"][1:].double() + (steps - 1) * (
        start["field"][:1].double() * DT)).float()
    vmax = ref.nan_ignoring_max(start["ions"][3:])
    nums = particles.numbers(got, start, vmax, None, DT, steps)
    moving = sum(int((start[s][3:] != 0).sum()) for s in ("ions",
                                                            "electrons"))
    assert nums["x_off"] == moving > 0.9 * 6 * N
    assert nums["y_off"] == int((start["field"][:1] != 0).sum())
