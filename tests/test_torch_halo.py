"""The port's halo exchange over a mesh (``repro_torch.core.halo``)
against the JAX package's halo module, in process.

The JAX side pads the WHOLE array with its boundary policy
(``repro.core.halo.exchange_multi`` over fill-only axes, and
``pad_boundary_only`` chained per axis); the port splits the same array
into shards on a CPU mesh and runs its transfer schedule.  Every shard's
padded block, and every region ``assemble_region`` cuts from its blocks,
must equal the matching slice of the reference's padded array exactly
(copies and fills only: no arithmetic but the LINEAR policy's, done the
same way on the same values), under all four boundary policies, on 1-,
2- and 3-axis meshes.  Fill-only schedules are held against the
reference's own ``exchange_blocks``/``assemble_region`` and its phase
structure, block shapes and ``halo.block`` trips."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.halo as ref
import repro_torch.core.halo as port
from repro_torch.core import make_mesh

# (mesh shape, partitioned storage axes, array shape, halo widths): every
# storage axis is haloed; axes beyond the mesh's are filled locally
CASES = {
    "1-axis": ((4,), (0,), (16, 6), (2, 1)),
    "2-axis": ((2, 4), (0, 1), (8, 12), (1, 2)),
    "3-axis": ((2, 2, 2), (0, 1, 2), (4, 6, 4), (1, 1, 2)),
    "2-axis-on-1": ((3, 1), (1, None), (5, 12), (1, 1)),
}
NAMES = ("a", "b", "c")


def _global(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _setup(case, boundary):
    mesh_shape, split, shape, widths = CASES[case]
    names = NAMES[:len(mesh_shape)]
    mesh = make_mesh(mesh_shape, names, devices=["cpu"] * int(
        np.prod(mesh_shape)))
    # storage axis -> mesh axis name
    axis_of = {ax: names[i] for i, ax in enumerate(split) if ax is not None}
    x = _global(shape)
    shards = []
    starts = []
    for i in range(mesh.size):
        coords = dict(zip(names, mesh.coords(i)))
        sl, st = [], []
        for ax, n in enumerate(shape):
            name = axis_of.get(ax)
            if name is None:
                sl.append(slice(None))
                st.append(0)
            else:
                m = n // mesh.shape[name]
                sl.append(slice(coords[name] * m, (coords[name] + 1) * m))
                st.append(coords[name] * m)
        shards.append(torch.from_numpy(x[tuple(sl)].copy()))
        starts.append(st)
    axes = [port.HaloAxis(ax, w, axis_of.get(ax))
            for ax, w in enumerate(widths)]
    ref_axes = [ref.HaloAxis(ax, w, None) for ax, w in enumerate(widths)]
    padded = np.asarray(ref.exchange_multi(
        jnp.asarray(x), ref_axes, boundary=ref.Boundary[boundary.name],
        constant=2.5))
    return mesh, x, shards, starts, axes, padded


def _ext_slice(shard, start, axes):
    """The slice of the globally padded array that one shard's extended
    array is: padded coordinates start at the shard's global start."""
    return tuple(slice(st, st + shard.shape[a.axis] + 2 * a.width)
                 for st, a in zip(start, axes))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("boundary", list(port.Boundary))
def test_every_padded_shard_is_a_slice_of_the_reference_padding(
        case, boundary):
    mesh, _, shards, starts, axes, padded = _setup(case, boundary)
    got = port.exchange_multi(shards, axes, boundary=boundary,
                              constant=2.5, mesh=mesh)
    assert len(got) == mesh.size
    for shard, start, ext in zip(shards, starts, got):
        np.testing.assert_array_equal(
            ext.numpy(), padded[_ext_slice(shard, start, axes)])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("boundary", list(port.Boundary))
def test_every_assembled_region_is_a_slice_of_the_reference_padding(
        case, boundary):
    """Sub-regions that cross the low zone, the shard and the high zone
    in every combination (the overlapped lowering's strip inputs)."""
    mesh, _, shards, starts, axes, padded = _setup(case, boundary)
    blocks = port.exchange_blocks(shards, axes, boundary=boundary,
                                  constant=2.5, mesh=mesh)
    for shard, start, b in zip(shards, starts, blocks):
        ext = padded[_ext_slice(shard, start, axes)]
        per_axis = []
        for a in axes:
            w, m = a.width, shard.shape[a.axis]
            per_axis.append([(0, m + 2 * w), (0, w + 1), (w, m + w),
                             (m + w - 1, m + 2 * w), (w - 1, w + 1)])
        for ranges in itertools.product(*per_axis):
            sub = port.assemble_region(b, axes, list(ranges))
            want = ext[tuple(slice(lo, hi) for lo, hi in ranges)]
            np.testing.assert_array_equal(sub.numpy(), want)


@pytest.mark.parametrize("boundary", list(port.Boundary))
def test_exchange_and_halo_blocks_match_per_axis_padding(boundary):
    """One partitioned axis at a time: ``exchange`` (blocks then
    concatenation) equals the reference's padding of the whole array
    along that axis, sliced per shard."""
    mesh = make_mesh((4,), ("d",), devices=["cpu"] * 4)
    x = _global((12, 5))
    shards = [torch.from_numpy(x[3 * i:3 * i + 3].copy()) for i in range(4)]
    want = np.asarray(ref.pad_boundary_only(
        jnp.asarray(x), axis=0, width=2,
        boundary=ref.Boundary[boundary.name], constant=-1.0))
    got = port.exchange(shards, mesh, axis=0, width=2, axis_name="d",
                        boundary=boundary, constant=-1.0)
    lows, highs = port.halo_blocks(shards, mesh, axis=0, width=2,
                                   axis_name="d", boundary=boundary,
                                   constant=-1.0)
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), want[3 * i:3 * i + 7])
        np.testing.assert_array_equal(lows[i].numpy(), want[3 * i:3 * i + 2])
        np.testing.assert_array_equal(highs[i].numpy(),
                                      want[3 * i + 5:3 * i + 7])


def test_a_block_from_a_neighbour_is_a_copy():
    """A received block is a new tensor (the neighbour's edge strip copied
    onto this shard's device), never a view of the neighbour's shard."""
    mesh = make_mesh((2,), ("d",), devices=["cpu"] * 2)
    shards = [torch.zeros(4, 3), torch.ones(4, 3)]
    lows, highs = port.halo_blocks(shards, mesh, axis=0, width=1,
                                   axis_name="d")
    assert highs[0].data_ptr() != shards[1].data_ptr()
    shards[1].fill_(7.0)
    assert bool((highs[0] == 1.0).all())


# -- fill-only schedules against the reference's own --------------------------

@pytest.mark.parametrize("boundary", list(port.Boundary))
def test_fill_only_blocks_and_regions_match_the_reference(boundary):
    x = np.arange(20.0, dtype=np.float32).reshape(4, 5)
    p_axes = [port.HaloAxis(0, 1), port.HaloAxis(1, 2)]
    r_axes = [ref.HaloAxis(0, 1, None), ref.HaloAxis(1, 2, None)]
    pb = port.exchange_blocks(torch.from_numpy(x), p_axes,
                              boundary=boundary, constant=7.0)
    rb = ref.exchange_blocks(jnp.asarray(x), r_axes,
                             boundary=ref.Boundary[boundary.name],
                             constant=7.0)
    assert set(pb) == set(rb)
    for k in rb:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(rb[k]))
    for ranges in ([(0, 6), (0, 9)], [(0, 3), (2, 9)], [(1, 5), (0, 4)],
                   [(5, 6), (7, 9)], [(1, 5), (2, 7)]):
        np.testing.assert_array_equal(
            port.assemble_region(pb, p_axes, ranges).numpy(),
            np.asarray(ref.assemble_region(rb, r_axes, ranges)))


@pytest.mark.parametrize("widths", [(1, 1), (1, 0, 1), (1, 1, 2),
                                    (0, 2), (2, 1, 0, 1)])
def test_block_keys_shapes_and_phases_match_the_reference(widths):
    p_axes = [port.HaloAxis(i, w, "m") for i, w in enumerate(widths)]
    r_axes = [ref.HaloAxis(i, w, "m") for i, w in enumerate(widths)]
    shape = tuple(3 + i for i in range(len(widths)))
    assert list(port.iter_block_keys(p_axes)) == \
        list(ref.iter_block_keys(r_axes))
    assert list(port.schedule_blocks(shape, p_axes)) == \
        list(ref.schedule_blocks(shape, r_axes))
    keys = list(port.iter_block_keys(p_axes))
    nonzero = sum(1 for w in widths if w)
    assert len(keys) == 3 ** nonzero - 1
    assert all(len(k) == p for p, k in keys)


def test_halo_block_trips_once_per_scheduled_block_pair(monkeypatch):
    """The ``halo.block`` fault site trips where the reference's does:
    once per (block, axis) extension, for all shards of a mesh at once."""
    trips = {"port": [], "ref": []}
    monkeypatch.setattr(port, "_fault_trip",
                        lambda site, detail="": trips["port"].append(
                            (site, detail)))
    monkeypatch.setattr(ref, "_fault_trip",
                        lambda site, detail="": trips["ref"].append(
                            (site, detail.replace("fill", "a"))))
    mesh = make_mesh((2, 2), ("a", "b"), devices=["cpu"] * 4)
    shards = [torch.zeros(4, 4) for _ in range(4)]
    port.exchange_blocks(shards, [port.HaloAxis(0, 1, "a"),
                                  port.HaloAxis(1, 1, "b")], mesh=mesh)
    ref.exchange_blocks(jnp.zeros((4, 4)), [ref.HaloAxis(0, 1, None),
                                            ref.HaloAxis(1, 1, None)])
    assert [s for s, _ in trips["port"]] == ["halo.block"] * 4
    assert [d.split(":")[0] for _, d in trips["port"]] == \
        [d.split(":")[0] for _, d in trips["ref"]]


def test_a_named_axis_needs_the_shards_and_their_mesh():
    mesh = make_mesh((2,), ("d",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="names a mesh axis"):
        port.exchange_blocks(torch.zeros(4), [port.HaloAxis(0, 1, "d")])
    with pytest.raises(ValueError, match="need the mesh"):
        port.exchange_blocks([torch.zeros(2)] * 3,
                             [port.HaloAxis(0, 1, "d")], mesh=mesh)


def _window_sum(s, widths):
    """Sum of the array over every offset of the halo window: each output
    cell reads every halo cell its window reaches (edges and corners)."""
    out = 0.0
    inner = [n - 2 * w for n, w in zip(s.shape, widths)]
    for offs in itertools.product(*(range(2 * w + 1) for w in widths)):
        out = out + s[tuple(slice(o, o + m) for o, m in zip(offs, inner))]
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("boundary", list(port.Boundary))
def test_regions_exchange_through_the_executor(case, boundary):
    """The same exchanges inside a graph node under ``regions=True`` (the
    blocks made in the piece, on the CPU without capture): the mesh's
    result equals ``regions=False``'s bit for bit, and the window sum of
    the reference's padding."""
    from repro_torch import core as tcore

    mesh_shape, split, shape, widths = CASES[case]
    names = NAMES[:len(mesh_shape)]
    mesh, x, _, _, _, padded = _setup(case, boundary)
    partition = tuple(names[split.index(d)] if d in split else None
                      for d in range(len(shape)))
    src = tcore.DistTensor("src", shape, partition=partition, halo=widths,
                           boundary=tcore.Boundary[boundary.name],
                           boundary_constant=2.5)
    dst = tcore.DistTensor("dst", shape, partition=partition)
    g = tcore.Graph().split(lambda s, _d: _window_sum(s, widths),
                            tcore.concurrent_padded_access(src), dst)
    x0 = torch.from_numpy(x)
    eager = tcore.Executor(g, mesh=mesh, regions=False)
    want = eager.read(eager(eager.init_state(src=x0)), dst)
    ex = tcore.Executor(g, mesh=mesh, regions=True, donate=True)
    for _ in range(2):
        got = ex.read(ex(ex.init_state(src=x0)), dst)
        assert torch.equal(got, want)
    np.testing.assert_allclose(
        got.numpy(), _window_sum(torch.from_numpy(padded.copy()),
                                widths).numpy(),
        rtol=1e-5, atol=1e-5)
