"""Quickstart: the Ripple core API on PyTorch in five minutes (paper
Listings 1-9), section by section as ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py            # the GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

``--device cpu`` runs the kernels' plain PyTorch versions.  The block
between the ``--8<-- [start:readme]`` markers is embedded verbatim (less
its indent) in README.md; ``tests/test_torch_examples.py`` asserts the
two stay in sync.
"""

import argparse

import torch

from repro_torch.core import (Boundary, DistTensor, Executor, Graph, Layout,
                              RecordArray, RecordSpec, SumReducer, Vector,
                              concurrent_padded_access, execute,
                              make_reduction_result, preferred_layout,
                              relayout)


def saxpy(device=None) -> torch.Tensor:
    """Section 2 on its own, so that its imports are the README's."""
    # -----------------------------------------------------------------------
    # 2. Tensors + graphs (paper Listing 7): SAXPY as a split node
    #    (this block is the README's tested quickstart snippet)
    # -----------------------------------------------------------------------
    # --8<-- [start:readme]
    import torch

    from repro_torch.core import DistTensor, Executor, Graph

    size = 1024
    x = DistTensor("x", (size,))
    y = DistTensor("y", (size,))

    g = Graph()
    g.split(lambda a, xs, ys: a * xs + ys, 2.0, x, y)   # writes y (last arg)

    ex = Executor(g, device=device)   # None: the GPU; "cpu": plain PyTorch
    state = ex.init_state(x=torch.arange(size, dtype=torch.float32),
                          y=torch.ones(size))
    state = ex.run(state, steps=1)    # one captured graph, replayed after
    assert (state["y"].cpu() == 2 * torch.arange(size) + 1).all()
    state = ex.run(state, steps=2)    # the state passed back is donated
    print(ex.plan.describe())   # schedule + regions + cache + tuning report
    # --8<-- [end:readme]
    return state["y"].cpu()


def run(device=None) -> dict:
    """Every section on ``device`` (None: the GPU); returns what each
    printed."""
    shown = {}

    # -----------------------------------------------------------------------
    # 1. Polymorphic layout (paper Listing 2): one record type, two layouts
    # -----------------------------------------------------------------------
    State = RecordSpec.create("density", "pressure", Vector("vel", 2))

    fields = {"density": torch.ones(4, 4),
              "pressure": torch.full((4, 4), 2.0),
              "vel": torch.zeros(4, 4, 2)}
    aos = RecordArray.from_fields(State, fields, Layout.AOS)  # (*space, C)
    soa = aos.with_layout(Layout.SOA)                           # (C, *space)
    print("AoS storage:", tuple(aos.data.shape), "| SoA storage:",
          tuple(soa.data.shape))
    assert float(soa.field("pressure")[0, 0]) == 2.0  # accessors hide layout

    shown["saxpy"] = saxpy(device)

    # -----------------------------------------------------------------------
    # 3. Reduction + conditional (paper Listings 8/9): map-reduce loop
    # -----------------------------------------------------------------------
    t = DistTensor("t", (256,))
    total = make_reduction_result("total")

    init = Graph(name="init")
    init.split(lambda v: torch.full_like(v, 3.0), t, writes=(0,))

    loop = Graph(name="map_reduce")
    loop.split(lambda v: v - 1.0, t, writes=(0,))
    loop.then_reduce(t, total, SumReducer())
    loop.conditional(lambda s: s["total"] != 0.0)

    main_g = Graph()
    main_g.emplace(init)
    main_g.then(loop)
    state = execute(main_g, device)
    shown["total"] = float(state["total"])
    print("map-reduce converged: total =", shown["total"])

    # -----------------------------------------------------------------------
    # 4. Stencils with halo (paper Listing 10): padded concurrent access
    # -----------------------------------------------------------------------
    src = DistTensor("src", (64,), halo=(1,), boundary=Boundary.TRANSMISSIVE)
    dst = DistTensor("dst", (64,))
    g = Graph()
    g.split(lambda s, d: s[2:] - s[:-2], concurrent_padded_access(src), dst)
    state = execute(g, device, src=torch.arange(64.0) ** 2)
    shown["central"] = state["dst"][1:4].cpu()
    print("central difference[1:4] =", shown["central"])

    # -----------------------------------------------------------------------
    # 5. Layout selection: user pin vs solver-chosen (paper §4.2)
    # -----------------------------------------------------------------------
    # Three layouts exist: AOS (*space, C), SOA (C, *space), and the tiled
    # AOSOA (*space[:-1], n_tiles, C, tile).  relayout() converts exactly.
    rec = RecordArray.from_fields(State, fields, Layout.SOA)
    print("AoSoA storage:", tuple(relayout(rec, Layout.AOSOA).data.shape))

    # (a) User pin: pin_layout=True forces the executor to keep your layout.
    p = DistTensor("p", (4, 256), spec=State, layout=Layout.AOS,
                   pin_layout=True)
    g = Graph()
    g.split(lambda r: r.set_field("density", r.field("density") + 1.0), p,
            writes=(0,))
    ex = Executor(g, device=device)
    shown["pinned"] = ex.plan.per_segment[0]["p"]
    print("pinned choice:", shown["pinned"])                   # Layout.AOS

    # (b) Solver-chosen: annotate a node with the kernel's preferred layout
    # (preferred_layout(...) or layout= on split/emplace) and the
    # per-segment layout solver honors it, inserting relayouts at segment
    # boundaries when producer and consumer segments disagree.
    q = DistTensor("q", (4, 256), spec=State)                 # declared SOA
    g = Graph()
    g.split(lambda r: r.set_field("density", r.field("density") * 2.0),
            preferred_layout(q, Layout.AOSOA), writes=(0,))
    ex = Executor(g, device=device)
    shown["solver"] = ex.plan.per_segment[0]["q"]
    print("solver choice:", shown["solver"])                   # AOSOA
    print("relayout steps:", ex.plan.relayouts)               # [] (one seg)

    # (c) Measured: Executor(tune="auto") times the halo-feasible layouts
    # per state key (x each kernel's tile_candidates()) with real runs,
    # commits the argmin, and persists the decision in
    # ~/.cache/repro-tune (or $REPRO_TUNE_CACHE) so the next process loads
    # it with zero measurements:
    ex = Executor(g, device=device, tune="auto")
    shown["tuning"] = ex.plan.tuning.source
    print(ex.plan.describe_tuning())

    print("\nOn a mesh, DistTensor(partition=('gx',)) shards the space and")
    print("the same graph runs one program per shard with halo exchange -")
    print("see tests/test_torch_mesh.py and examples/euler2d_torch.py.")
    return shown


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
