"""The port's layouts and local halos against the JAX package, on the CPU.

Inputs are made with NumPy and fed to both packages; storage is compared
raw, since ``aosoa_tile`` and the storage shapes are the same in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port

LAYOUTS = ["AOS", "SOA", "AOSOA"]
BOUNDARIES = ["TRANSMISSIVE", "LINEAR", "PERIODIC", "CONSTANT"]


def _specs():
    return (ref.RecordSpec.create("rho", "E", ref.Vector("mom", 2)),
            port.RecordSpec.create("rho", "E", port.Vector("mom", 2)))


def _fields(seed, space):
    rng = np.random.default_rng(seed)
    return {"rho": rng.standard_normal(space, dtype=np.float32),
            "E": rng.standard_normal(space, dtype=np.float32),
            "mom": rng.standard_normal((*space, 2), dtype=np.float32)}


def _both(fields, layout):
    rs, ps = _specs()
    r = ref.RecordArray.from_fields(
        rs, {k: jnp.asarray(v) for k, v in fields.items()},
        ref.Layout[layout])
    p = port.RecordArray.from_fields(
        ps, {k: torch.from_numpy(v) for k, v in fields.items()},
        port.Layout[layout])
    return r, p


@pytest.mark.parametrize("space", [(6, 5), (2, 256), (1024,), (3, 192)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_storage_shape_matches_reference(space, layout):
    rs, ps = _specs()
    assert port.RecordArray.storage_shape(ps, space, port.Layout[layout]) \
        == ref.RecordArray.storage_shape(rs, space, ref.Layout[layout])


def test_aosoa_tile_matches_reference():
    for n in (1, 7, 64, 128, 192, 1024, 4096, 1000):
        assert port.aosoa_tile(n) == ref.aosoa_tile(n)
    with pytest.raises(ValueError):
        port.aosoa_tile(0)


@pytest.mark.parametrize("space", [(4, 3), (3, 8), (512,)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_from_fields_storage_and_fields_match(space, layout):
    fields = _fields(1, space)
    r, p = _both(fields, layout)
    assert p.space == tuple(r.space) and p.layout.name == layout
    np.testing.assert_array_equal(p.data.numpy(), np.asarray(r.data))
    for name, v in fields.items():
        np.testing.assert_array_equal(p.field(name).numpy(), v)
        assert torch.equal(p.to_fields()[name], p.field(name))


@pytest.mark.parametrize("src", LAYOUTS)
@pytest.mark.parametrize("dst", LAYOUTS)
def test_relayout_all_pairs_match_reference(src, dst):
    r, p = _both(_fields(2, (3, 8)), src)
    rb = ref.relayout(r, ref.Layout[dst])
    pb = port.relayout(p, port.Layout[dst])
    assert pb.layout.name == dst and pb.data.is_contiguous()
    np.testing.assert_array_equal(pb.data.numpy(), np.asarray(rb.data))
    np.testing.assert_array_equal(
        port.relayout_data(p.data, p.spec, p.layout, pb.layout).numpy(),
        np.asarray(rb.data))
    back = port.relayout(pb, port.Layout[src])
    assert torch.equal(back.data, p.data)
    if src != dst:   # a conversion never aliases its input
        assert pb.data.data_ptr() != p.data.data_ptr()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_set_field_matches_reference(layout):
    r, p = _both(_fields(3, (5, 4)), layout)
    v = np.random.default_rng(4).standard_normal((5, 4, 2), dtype=np.float32)
    r2 = r.set_field("mom", jnp.asarray(v))
    before = p.data.clone()
    p2 = p.set_field("mom", torch.from_numpy(v))
    np.testing.assert_array_equal(p2.data.numpy(), np.asarray(r2.data))
    assert torch.equal(p.data, before)   # functional: input unchanged
    with pytest.raises(ValueError):
        p.set_field("E", torch.zeros(3))


def test_spec_validation_and_candidates():
    with pytest.raises(ValueError):
        port.RecordSpec.create("a", "a")
    with pytest.raises(ValueError):
        port.Field("x", 0)
    with pytest.raises(KeyError):
        _specs()[1].offset("nope")
    for kw in ({}, {"halo": (0, 1)}, {"halo": (1, 0)},
               {"partition": (None, "d")}):
        assert [l.name for l in port.storage_candidates((4, 256), **kw)] \
            == [l.name for l in ref.storage_candidates((4, 256), **kw)]


def test_dispatch_with_relayout_stages_unsupported_layouts():
    _, p = _both(_fields(5, (2, 128)), "AOSOA")
    seen = []

    def kern(rec, scale):
        seen.append(rec.layout)
        return rec.map_data(lambda d: d * scale)

    out = port.dispatch_with_relayout(
        kern, p, 2.0, supported=(port.Layout.SOA,),
        preferred=port.Layout.SOA)
    assert seen == [port.Layout.SOA] and out.layout is port.Layout.AOSOA
    assert torch.equal(out.data, p.data * 2.0)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("layout", ["AOS", "SOA"])
def test_two_axis_halo_with_corners_matches_exchange_multi(boundary,
                                                           layout):
    """Local fill of both space axes of a record, corners included, equals
    the reference's transfer schedule for every boundary policy."""
    r, p = _both(_fields(6, (6, 5)), layout)
    axes = [1, 2] if layout == "SOA" else [0, 1]
    widths = [2, 1]
    rb, pb = ref.Boundary[boundary], port.Boundary[boundary]
    want = ref.exchange_multi(
        r.data, [ref.HaloAxis(a, w) for a, w in zip(axes, widths)],
        boundary=rb, constant=3.5)
    got = port.exchange_multi(
        p.data, [port.HaloAxis(a, w) for a, w in zip(axes, widths)],
        boundary=pb, constant=3.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = got
    for a, w in zip(axes, widths):
        back = port.unpad(back, axis=a, width=w)
    assert torch.equal(back, p.data)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("n,width", [(7, 2), (1, 1), (3, 5)])
def test_pad_boundary_only_matches_reference(boundary, n, width):
    """One axis, including a single cell and a PERIODIC halo wider than
    the array."""
    x = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    want = ref.pad_boundary_only(jnp.asarray(x), axis=0, width=width,
                                 boundary=ref.Boundary[boundary],
                                 constant=-1.0)
    got = port.pad_boundary_only(torch.from_numpy(x), axis=0, width=width,
                                 boundary=port.Boundary[boundary],
                                 constant=-1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        port.interior(got, axis=0, width=width).numpy(), x)


def test_halo_on_partitioned_axis_is_refused():
    """A halo axis that names a mesh axis needs the shards and their
    mesh: one tensor alone is refused."""
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="names a mesh axis"):
        port.exchange_multi(x, [port.HaloAxis(0, 1, "d")])
