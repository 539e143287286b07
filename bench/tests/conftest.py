"""What the benchmark's shared tests need of the finite-volume cells,
whose files ``common.py`` and ``bench/control.py`` predate: the small
size of ``flux-t4`` in ``common.SMALL``, and, for a cell whose driver is
``flux``, the control of ``bench/control_flux.py`` in the place of
``control.readings`` (which branches between the particle and eikonal
drivers only)."""

from __future__ import annotations

import pytest

from .common import SMALL

FLUX_SMALL = {"nx": 64, "ny": 32}
SMALL.setdefault("flux-t4", FLUX_SMALL)


@pytest.fixture(autouse=True)
def _flux_control(monkeypatch):
    from bench import control, control_flux, harness

    plain = control.readings

    def readings(workload, seed, steps, device="cuda", overrides=None,
                 root=harness.ROOT):
        entry = harness.cell_entry(harness.load_benchmark(root), workload)
        config = harness.load_json("configs", entry["config"], root / "bench")
        fn = control_flux.readings if config["driver"] == "flux" else plain
        return fn(workload, seed, steps, device=device, overrides=overrides,
                  root=root)

    monkeypatch.setattr(control, "readings", readings)
