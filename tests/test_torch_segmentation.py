"""The port's §V.B field segmentation (repro_torch.kernels grad_mag and
repro_torch.apps.segmentation) against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages.  The
JAX side runs its Pallas kernel in interpret mode and its jnp oracle; the
port is given CPU tensors or ``device="cpu"``, so it runs its plain PyTorch
version (the CUDA kernel itself is held against that version on the card,
in tests/test_torch_cuda.py and chip_smoke.py).  Tolerances are those of
tests/test_kernels.py: grad_sum 1e-5, count exact, bf16 2e-2.  Edge maps
can differ on a threshold tie (the JAX cloud score is host numpy), so they
are held to the 0.999 bar of examples/field_segmentation.py; labels and
GeoJSON are compared byte for byte from the same edge map.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import segmentation as jseg
from repro.configs.festivus_imagery import SMOKE as J_SMOKE
from repro.core import ChunkStore as JChunkStore
from repro.core import Festivus as JFestivus
from repro.core import LocalDirObjectStore as JLocalDir
from repro.data import imagery as jimagery
from repro.kernels import ref as jref
from repro.kernels.grad_mag import grad_mag_fwd
from repro_torch.apps import segmentation as pseg
from repro_torch.configs.festivus_imagery import SMOKE
from repro_torch.core import ChunkStore, Festivus, FlakyObjectStore
from repro_torch.core import InMemoryObjectStore, LocalDirObjectStore
from repro_torch.data import imagery
from repro_torch.kernels import backend, build, ops, ref
from repro_torch.kernels import grad_mag as kgrad

G_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
EDGE_AGREEMENT = 0.999  # examples/field_segmentation.py:37


def _stack(shape, seed, valid_frac=0.7):
    rng = np.random.default_rng(seed)
    T, H, W, _ = shape
    return (rng.random(shape, dtype=np.float32),
            rng.random((T, H, W)) < valid_frac)


def _port_grad_mag(x, v, dtype=torch.float32):
    return ops.grad_mag(torch.from_numpy(x).to(dtype), torch.from_numpy(v))


# ---------------------------------------------------------------------------
# kernels: ref.grad_mag against the Pallas kernel (interpret) and jnp oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 16, 16, 2), (5, 24, 40, 4),
                                   (7, 24, 37, 3)])
def test_ref_grad_mag_matches_jax_kernel_and_oracle(shape):
    x, v = _stack(shape, seed=11)
    g, c = _port_grad_mag(x, v)
    assert g.dtype == c.dtype == torch.float32
    assert tuple(g.shape) == tuple(c.shape) == shape[1:3]
    jx, jv = jnp.asarray(x), jnp.asarray(v)
    for jg, jc in (grad_mag_fwd(jx, jv, block_h=8, interpret=True),
                   jref.grad_mag(jx, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **G_TOL)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_ref_grad_mag_ragged_height_matches_jax_oracle():
    """H = 37 is refused by the Pallas wrapper (H % block_h), not by the
    port: the oracle is the reference here."""
    x, v = _stack((7, 37, 53, 3), seed=12)
    g, c = _port_grad_mag(x, v)
    jg, jc = jref.grad_mag(jnp.asarray(x), jnp.asarray(v))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **G_TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("shape", [(3, 16, 16, 2), (5, 24, 40, 4)])
def test_ref_grad_mag_bf16_matches_jax(shape):
    x, v = _stack(shape, seed=13)
    jx = jnp.asarray(x, jnp.bfloat16)
    same = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    g, c = ops.grad_mag(same.to(torch.bfloat16), torch.from_numpy(v))
    jv = jnp.asarray(v)
    for jg, jc in (grad_mag_fwd(jx, jv, block_h=8, interpret=True),
                   jref.grad_mag(jx, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg, np.float32),
                                   **BF16_TOL)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_grad_mag_one_valid_pixel_adds_sqrt_eps():
    """A valid pixel whose neighbours are all invalid still adds
    sqrt(eps): the eps is inside the sqrt."""
    x = np.random.default_rng(0).random((2, 8, 8, 3), dtype=np.float32)
    v = np.zeros((2, 8, 8), bool)
    v[1, 3, 4] = True
    g, c = _port_grad_mag(x, v)
    want_g = np.zeros((8, 8), np.float32)
    want_g[3, 4] = np.sqrt(np.float32(1e-6))
    want_c = np.zeros((8, 8), np.float32)
    want_c[3, 4] = 1.0
    np.testing.assert_array_equal(g.numpy(), want_g)
    np.testing.assert_array_equal(c.numpy(), want_c)
    jg, jc = jref.grad_mag(jnp.asarray(x), jnp.asarray(v))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **G_TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_grad_mag_all_invalid_is_zero():
    g, c = ops.grad_mag(torch.ones((2, 8, 8, 1)),
                        torch.zeros((2, 8, 8), dtype=torch.bool))
    assert float(g.abs().max()) == 0.0 and float(c.abs().max()) == 0.0


def test_temporal_mean_gradient_matches_jax():
    x, v = _stack((4, 16, 24, 4), seed=14)
    got = ref.temporal_mean_gradient(torch.from_numpy(x), torch.from_numpy(v))
    want = jref.temporal_mean_gradient(jnp.asarray(x), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **G_TOL)


def test_grad_mag_ops_on_cpu_runs_plain_version_without_launching():
    x, v = (torch.from_numpy(a) for a in _stack((3, 8, 16, 4), seed=2))
    backend.reset_launch_counts()
    auto = ops.grad_mag(x, v)
    plain = ops.grad_mag(x, v, impl="ref")
    for a, b in zip(auto, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        ops.grad_mag(x, v, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.grad_mag(x, v, impl="pallas")
    assert backend.launch_counts()["grad_mag"] == 0
    assert kgrad.launches.count == 0


def _bad_inputs(case):
    x = torch.rand((3, 8, 16, 4))
    v = torch.rand((3, 8, 16)) > 0.5
    if case == "valid_shape":
        return x, v[:, :4]
    if case == "too_many_channels":
        return torch.rand((3, 8, 16, 9)), v
    if case == "images_dtype":
        return x.to(torch.float16), v
    if case == "valid_dtype":
        return x, v.to(torch.uint8)
    if case == "not_4d":
        return x[0], v
    if case == "non_contiguous":
        return x.transpose(1, 2), v.transpose(1, 2)
    if case == "cpu_tensors":
        return x, v
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["valid_shape", "too_many_channels",
                                  "images_dtype", "valid_dtype", "not_4d",
                                  "non_contiguous", "cpu_tensors"])
def test_grad_mag_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, v = _bad_inputs(case)
    before = kgrad.launches.count
    with pytest.raises((ValueError, TypeError)):
        kgrad.grad_mag(x, v)
    assert kgrad.launches.count == before


def test_grad_mag_source_is_built_with_the_others():
    assert {"composite", "grad_mag"} <= set(build.source_names())
    path = build.library_path("grad_mag")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libgrad_mag-") and path.suffix == ".so"
    assert path != build.library_path("composite")


# ---------------------------------------------------------------------------
# morphology, connected components, polygonize: byte-equal to JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("closing_steps", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clean_edges_byte_equal_to_jax(seed, closing_steps):
    rng = np.random.default_rng(seed)
    edges = rng.random((33, 47)) < 0.3
    got = pseg.clean_edges(edges, closing_steps, device="cpu")
    want = np.asarray(jseg.clean_edges(edges, closing_steps))
    assert got.dtype == want.dtype == np.bool_
    assert got.tobytes() == want.tobytes()
    # tensors stay tensors, on their device
    t = pseg.clean_edges(torch.from_numpy(edges), closing_steps)
    assert isinstance(t, torch.Tensor) and t.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("density", [0.45, 0.6, 0.8])
@pytest.mark.parametrize("seed", [0, 1])
def test_connected_components_byte_equal_to_jax(seed, density):
    mask = np.random.default_rng(seed).random((41, 59)) < density
    got, iterations = pseg.connected_components(mask, device="cpu")
    want = np.asarray(jseg.connected_components(jnp.asarray(mask)))
    assert got.dtype == np.int32 and got.shape == mask.shape
    assert got.tobytes() == want.tobytes()
    assert iterations % pseg.CHECK_EVERY == 0


def _serpentine(h, w):
    """One corridor that winds down the tile row by row: its flood needs
    about h*w/2 iterations."""
    mask = np.zeros((h, w), bool)
    mask[::2] = True
    for r in range(1, h, 2):
        mask[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return mask


def test_connected_components_serpentine_needs_hundreds_of_iterations(
        monkeypatch):
    mask = _serpentine(31, 40)
    got, iterations = pseg.connected_components(mask, device="cpu")
    want = np.asarray(jseg.connected_components(jnp.asarray(mask)))
    assert got.tobytes() == want.tobytes()
    assert np.unique(got[mask]).tolist() == [1]  # one component
    assert iterations >= 500 and iterations % pseg.CHECK_EVERY == 0
    # testing the fixpoint after every iteration gives the same labels
    k = pseg.CHECK_EVERY
    monkeypatch.setattr(pseg, "CHECK_EVERY", 1)
    every, n = pseg.connected_components(mask, device="cpu")
    assert every.tobytes() == want.tobytes()
    assert n <= iterations < n + 2 * k  # one interval may straddle it


def test_connected_components_edge_cases():
    for mask in (np.zeros((5, 7), bool), np.ones((5, 7), bool),
                 np.ones((1, 9), bool), np.ones((9, 1), bool)):
        got, _ = pseg.connected_components(mask, device="cpu")
        want = np.asarray(jseg.connected_components(jnp.asarray(mask)))
        assert got.tobytes() == want.tobytes()


def _label_map(seed):
    """Labels with gaps in the ids, components under 8 px and a background."""
    rng = np.random.default_rng(seed)
    labels = rng.choice(np.array([0, 3, 7, 8, 20, 1000, 65537], np.int32),
                        size=(29, 43), p=[0.3, 0.2, 0.2, 0.1, 0.1, 0.05, 0.05])
    labels[5, 5] = 42            # a one-pixel field
    labels[10:12, 30:33] = 77    # six pixels: dropped
    labels[20:24, 2:4] = 88      # eight pixels: kept
    return labels


@pytest.mark.parametrize("min_pixels", [1, 8, 50])
@pytest.mark.parametrize("seed", [0, 1])
def test_polygonize_json_byte_equal_to_jax(seed, min_pixels):
    labels = _label_map(seed)
    got = pseg.polygonize(labels, min_pixels)
    want = jseg.polygonize(labels, min_pixels)
    assert json.dumps(got) == json.dumps(want)
    ids = [f["properties"]["field_id"] for f in got["features"]]
    assert ids == sorted(ids)
    assert (88 in ids) == (min_pixels <= 8) and (77 in ids) == (min_pixels <= 6)
    for f in got["features"]:
        assert type(f["properties"]["field_id"]) is int
        assert all(type(c) is float for c in f["properties"]["centroid"])


def test_polygonize_on_flood_labels_and_empty():
    mask = np.random.default_rng(3).random((40, 40)) < 0.6
    labels, _ = pseg.connected_components(mask, device="cpu")
    assert (json.dumps(pseg.polygonize(torch.from_numpy(labels)))
            == json.dumps(jseg.polygonize(labels)))
    empty = np.zeros((6, 6), np.int32)
    assert pseg.polygonize(empty) == jseg.polygonize(empty)


# ---------------------------------------------------------------------------
# the tile chain and the campaign
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tile_px", [48, 64, 96])
def test_segment_tile_matches_jax(tile_px, seed):
    spec = jimagery.SceneSpec(tile_px=tile_px, temporal_depth=6, seed=seed)
    imgs, valid = jimagery.scene_stack(spec)
    j_edges = jseg.temporal_edges(imgs, valid, J_SMOKE, impl="ref")
    p_edges = pseg.temporal_edges(imgs, valid, SMOKE, device="cpu")
    assert p_edges.dtype == np.bool_ and p_edges.shape == j_edges.shape
    assert (p_edges == j_edges).mean() > EDGE_AGREEMENT
    # from the same edge map, the rest of the chain is byte-identical
    j_labels = np.asarray(jseg.connected_components(
        jnp.asarray(~jseg.clean_edges(j_edges))))
    p_labels, _ = pseg.connected_components(
        ~pseg.clean_edges(j_edges, device="cpu"), device="cpu")
    assert p_labels.tobytes() == j_labels.tobytes()
    assert (json.dumps(pseg.polygonize(p_labels))
            == json.dumps(jseg.polygonize(j_labels)))

    labels, geo = pseg.segment_tile(imgs, valid, SMOKE, device="cpu")
    want_labels, want_geo = jseg.segment_tile(imgs, valid, J_SMOKE,
                                              impl="ref")
    assert labels.dtype == np.int32 and labels.shape == (tile_px, tile_px)
    if (p_edges == j_edges).all():
        assert labels.tobytes() == want_labels.tobytes()
        assert json.dumps(geo) == json.dumps(want_geo)
    assert len(geo["features"]) > 0


def _write_stacks(cs, imagery_mod, n=3):
    names = []
    for i in range(n):
        name = f"tiles/seg{i}"
        imagery_mod.write_scene_stack(
            cs, name, imagery_mod.SceneSpec(tile_px=48, temporal_depth=4,
                                            seed=30 + i), chunk_px=16)
        names.append(name)
    return names


def test_campaign_byte_identical_to_single_process():
    flaky = FlakyObjectStore(InMemoryObjectStore(), failure_rate=0.02, seed=7)
    cs = ChunkStore(Festivus(flaky), "bucket")
    names = _write_stacks(cs, imagery)
    backend.reset_launch_counts()
    out = pseg.run_segmentation_campaign(cs, names, SMOKE, num_workers=3,
                                         device="cpu")
    assert out["tiles"] == 3 and out["report"].all_done
    assert backend.launch_counts()["grad_mag"] == 0  # CPU: plain version
    for n in names:
        pseg.segment_to_store(cs, n, SMOKE, out_prefix="fields_ref",
                              device="cpu")
        got = cs.open(f"fields/{n}/labels").read_all()
        want = cs.open(f"fields_ref/{n}/labels").read_all()
        assert got.dtype == np.int32 and got.tobytes() == want.tobytes(), n
        assert (cs.fs.read(f"{cs.root}/fields/{n}/fields.geojson")
                == cs.fs.read(f"{cs.root}/fields_ref/{n}/fields.geojson")), n
    assert all(r["fields"] > 0 for r in out["report"].results.values())


def test_port_reads_the_labels_the_jax_campaign_wrote(tmp_path):
    jcs = JChunkStore(JFestivus(JLocalDir(str(tmp_path))), "bucket")
    names = _write_stacks(jcs, jimagery, n=2)
    jseg.run_segmentation_campaign(jcs, names, J_SMOKE, num_workers=2)

    fs = Festivus(LocalDirObjectStore(str(tmp_path)))
    assert fs.sync_metadata() > 0
    cs = ChunkStore(fs, "bucket")
    for n in names:
        got = cs.open(f"fields/{n}/labels").read_all()
        jlabels = jcs.open(f"fields/{n}/labels").read_all()
        assert got.dtype == np.int32 and got.tobytes() == jlabels.tobytes()
        geo = cs.fs.read(f"{cs.root}/fields/{n}/fields.geojson")
        assert geo == jcs.fs.read(f"{jcs.root}/fields/{n}/fields.geojson")
        # the port's own segmentation of the stack it reads there
        imgs, valid = imagery.read_scene_stack(cs, n)
        labels, own = pseg.segment_tile(imgs, valid, SMOKE, device="cpu")
        assert labels.tobytes() == got.tobytes()
        assert json.dumps(own).encode() == geo
