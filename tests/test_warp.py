"""Warp-engine kernel tests against closed-form panoramas and an
independent bilinear implementation (jax.scipy map_coordinates)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
from jax.scipy.ndimage import map_coordinates

from gs360x.kernels import warp
from gs360x.rig.spec import ViewSpec


def lonlat_pano(w=512, h=256):
    """Panorama encoding longitude (ch0, [0,1]) and latitude (ch1, [0,1]) as
    smooth wrap-periodic signals plus a constant ch2."""
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0   # lon / pi
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0   # lat / (pi/2)
    lon, lat = np.meshgrid(xs * math.pi, ys * math.pi / 2.0)
    return jnp.asarray(np.stack([
        0.5 + 0.5 * np.sin(lon),      # wrap-continuous longitude signal
        0.5 + 0.5 * np.sin(lat),
        np.full_like(lon, 0.25),
    ], axis=-1).astype(np.float32))


def expected_color(yaw_deg, pitch_deg):
    lon = math.radians(yaw_deg)
    lat = -math.radians(pitch_deg)  # pitch up = negative latitude (y down)
    return np.array([0.5 + 0.5 * math.sin(lon), 0.5 + 0.5 * math.sin(lat), 0.25])


def center_pixel(img):
    h, w = img.shape[:2]
    return np.asarray(img[h // 2 - 1:h // 2 + 1, w // 2 - 1:w // 2 + 1]).mean(axis=(0, 1))


class TestSamplers:
    def test_bilinear_matches_map_coordinates(self):
        rng = np.random.default_rng(0)
        src = jnp.asarray(rng.random((37, 53, 3)).astype(np.float32))
        u = jnp.asarray(rng.uniform(0, 52, (17, 19)).astype(np.float32))
        v = jnp.asarray(rng.uniform(0, 36, (17, 19)).astype(np.float32))
        ours = warp.sample_bilinear(src, u, v)
        ref = jnp.stack([
            map_coordinates(src[..., c], [v, u], order=1) for c in range(3)
        ], axis=-1)
        np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=1e-5)

    def test_integer_coords_are_exact(self):
        rng = np.random.default_rng(1)
        src = jnp.asarray(rng.random((16, 16, 1)).astype(np.float32))
        uu, vv = jnp.meshgrid(jnp.arange(16.0), jnp.arange(16.0))
        for interp in ("bilinear", "bicubic", "nearest"):
            out = warp._SAMPLERS[interp](src, uu, vv)
            np.testing.assert_allclose(np.asarray(out), np.asarray(src),
                                       atol=1e-5, err_msg=interp)

    def test_wrap_x(self):
        src = jnp.arange(8.0).reshape(1, 8, 1).repeat(2, axis=0)
        out = warp.sample_bilinear(src, jnp.array([[7.5]]), jnp.array([[0.0]]),
                                   wrap_x=True)
        # halfway between col 7 (=7) and wrapped col 0 (=0)
        assert float(out[0, 0, 0]) == pytest.approx(3.5)

    def test_bicubic_reproduces_linear_ramp(self):
        # cubic Lagrange interpolation is exact on polynomials up to deg 3
        src = jnp.broadcast_to(jnp.arange(32.0)[None, :, None], (8, 32, 1))
        u = jnp.asarray(np.random.default_rng(2).uniform(2, 29, (5, 5)).astype(np.float32))
        v = jnp.full((5, 5), 4.0)
        out = warp.sample_bicubic(src, u, v)
        np.testing.assert_allclose(np.asarray(out[..., 0]), np.asarray(u), atol=1e-4)

    def test_lagrange_weights_sum_to_one(self):
        t = jnp.linspace(0, 1, 33)
        for fn in (warp.lagrange_cubic_weights, warp.catmull_rom_weights):
            ws = fn(t)
            np.testing.assert_allclose(np.asarray(sum(ws)), 1.0, atol=1e-6)

    def test_lagrange_at_zero_hits_node(self):
        ws = warp.lagrange_cubic_weights(jnp.array(0.0))
        np.testing.assert_allclose([float(w) for w in ws], [0, 1, 0, 0], atol=1e-7)


class TestViewWarp:
    @pytest.mark.parametrize("yaw,pitch", [(0, 0), (45, 0), (90, 30), (-135, -45), (180, 0)])
    def test_view_center_matches_direction(self, yaw, pitch):
        pano = lonlat_pano()
        out = warp.warp_equirect_to_views(
            pano, jnp.array([float(yaw)]), jnp.array([float(pitch)]),
            jnp.array([0.0]), width=128, height=128, hfov_deg=90.0,
            vfov_deg=90.0, interp="bilinear")
        np.testing.assert_allclose(center_pixel(out[0]),
                                   expected_color(yaw, pitch), atol=2e-3)

    def test_seam_continuity(self):
        # a view straddling the +/-180 seam must stay smooth
        pano = lonlat_pano()
        out = warp.warp_equirect_to_views(
            pano, jnp.array([180.0]), jnp.array([0.0]), jnp.array([0.0]),
            width=256, height=64, hfov_deg=100.0, vfov_deg=30.0,
            interp="bicubic")
        row = np.asarray(out[0, 32, :, 0])
        assert np.max(np.abs(np.diff(row))) < 0.02  # no jump at the seam

    def test_constant_image_invariant(self):
        pano = jnp.full((128, 256, 3), 0.625, jnp.float32)
        out = warp.warp_equirect_to_views(
            pano, jnp.array([77.0]), jnp.array([12.0]), jnp.array([0.0]),
            width=96, height=96, hfov_deg=112.0, vfov_deg=112.0,
            interp="bicubic")
        np.testing.assert_allclose(np.asarray(out), 0.625, atol=1e-4)

    def test_bicubic_close_to_bilinear_on_smooth(self):
        pano = lonlat_pano()
        kw = dict(width=64, height=64, hfov_deg=90.0, vfov_deg=90.0)
        a = warp.warp_equirect_to_views(pano, jnp.array([30.0]), jnp.array([10.0]),
                                        jnp.array([0.0]), interp="bilinear", **kw)
        b = warp.warp_equirect_to_views(pano, jnp.array([30.0]), jnp.array([10.0]),
                                        jnp.array([0.0]), interp="bicubic", **kw)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-3)

    def test_fisheye_view_center(self):
        pano = lonlat_pano()
        out = warp.warp_equirect_to_views(
            pano, jnp.array([0.0]), jnp.array([0.0]), jnp.array([0.0]),
            width=128, height=128, hfov_deg=180.0, vfov_deg=180.0,
            projection="fisheye_v360", interp="bilinear")
        np.testing.assert_allclose(center_pixel(out[0]), expected_color(0, 0),
                                   atol=2e-3)

    def test_fisheye_corners_are_fill(self):
        pano = lonlat_pano()
        out = warp.warp_equirect_to_views(
            pano, jnp.array([0.0]), jnp.array([0.0]), jnp.array([0.0]),
            width=64, height=64, hfov_deg=180.0, vfov_deg=180.0,
            projection="fisheye_v360", interp="bilinear")
        assert float(jnp.abs(out[0, 0, 0]).max()) == 0.0
        assert float(jnp.abs(out[0, -1, -1]).max()) == 0.0

    def test_pitch_90_looks_at_pole(self):
        pano = lonlat_pano()
        out = warp.warp_equirect_to_views(
            pano, jnp.array([0.0]), jnp.array([90.0]), jnp.array([0.0]),
            width=64, height=64, hfov_deg=60.0, vfov_deg=60.0,
            interp="bilinear")
        # latitude channel at the up pole -> sin(-pi/2) -> 0.0
        assert center_pixel(out[0])[1] == pytest.approx(0.0, abs=5e-3)

    def test_batched_views_match_single(self):
        pano = lonlat_pano()
        kw = dict(width=48, height=48, hfov_deg=100.0, vfov_deg=100.0,
                  interp="bicubic")
        batched = warp.warp_equirect_to_views(
            pano, jnp.array([0.0, 45.0, 90.0]), jnp.array([0.0, 15.0, -15.0]),
            jnp.zeros(3), **kw)
        for i, (y, p) in enumerate([(0.0, 0.0), (45.0, 15.0), (90.0, -15.0)]):
            single = warp.warp_equirect_to_views(
                pano, jnp.array([y]), jnp.array([p]), jnp.zeros(1), **kw)
            np.testing.assert_allclose(np.asarray(batched[i]),
                                       np.asarray(single[0]), atol=1e-5)


class TestPlanWarp:
    def test_mixed_plan_grouping_preserves_order(self):
        pano = lonlat_pano()
        views = [
            ViewSpec("A", 0.0, 0.0, 90.0, 90.0, 64, 64),
            ViewSpec("X", 0.0, 0.0, 180.0, 180.0, 32, 32, projection="fisheye_v360"),
            ViewSpec("B", 45.0, 0.0, 90.0, 90.0, 64, 64),
        ]
        outs = warp.warp_plan_views(pano, views, interp="bilinear")
        assert outs[0].shape == (64, 64, 3)
        assert outs[1].shape == (32, 32, 3)
        assert outs[2].shape == (64, 64, 3)
        np.testing.assert_allclose(center_pixel(outs[2]), expected_color(45, 0),
                                   atol=2e-3)

    def test_dense_reference_agrees(self):
        pano = lonlat_pano()
        view = ViewSpec("A", 30.0, -20.0, 100.0, 80.0, 56, 40)
        dense = warp.warp_equirect_dense_reference(pano, view, interp="bilinear")
        fast = warp.warp_equirect_to_views(
            pano, jnp.array([30.0]), jnp.array([-20.0]), jnp.array([0.0]),
            width=56, height=40, hfov_deg=100.0, vfov_deg=80.0,
            interp="bilinear")[0]
        np.testing.assert_allclose(np.asarray(dense), np.asarray(fast), atol=1e-5)


class TestShardedBatchWarp:
    """Multi-device batch path (runs fully only on a multi-device host;
    on one device the mesh is size-1 and the math still must hold)."""

    def test_batch_matches_per_frame(self):
        import jax
        import jax.numpy as jnp

        from gs360x.kernels import warp as warplib
        from gs360x.runtime import mesh as meshlib

        n = jax.device_count()
        rng = np.random.default_rng(0)
        frames = (rng.random((max(2, n), 128, 256, 3)) * 255).astype(np.uint8)
        yaws = np.array([0.0, 90.0], np.float32)
        zeros = np.zeros(2, np.float32)
        m = meshlib.data_mesh()
        out = meshlib.warp_frames_sharded(
            m, jnp.asarray(frames[:n] if n > 1 else frames[:1]),
            yaws, zeros, zeros, width=64, height=64, hfov_deg=90.0,
            vfov_deg=90.0, interp="bilinear", quantize_bits=8)
        assert out.dtype == jnp.uint8
        ref = warplib._warp_equirect_to_views_xla(
            jnp.asarray(frames[0].astype(np.float32) / 255.0),
            jnp.asarray(yaws), jnp.asarray(zeros), jnp.asarray(zeros),
            width=64, height=64, hfov_deg=90.0, vfov_deg=90.0,
            projection="perspective", interp="bilinear")
        ref8 = np.rint(np.clip(np.asarray(ref), 0, 1) * 255).astype(np.uint8)
        diff = np.abs(np.asarray(out[0]).astype(int) - ref8.astype(int))
        assert diff.max() <= 1

    @pytest.mark.parametrize("batch", [8, 5, 1, 11])
    def test_sharded_8dev_matches_one_device(self, batch):
        """The 8-device CPU mesh against a 1-device mesh, including batches
        that do not divide by the mesh (a video's tail is padded with its
        last frame, and the padding dropped)."""
        import jax

        from gs360x.runtime import mesh as meshlib

        devs = jax.devices()
        assert len(devs) == 8
        rng = np.random.default_rng(batch)
        frames = (rng.random((batch, 32, 64, 3)) * 255).astype(np.uint8)
        kw = dict(width=24, height=16, hfov_deg=90.0, vfov_deg=70.0,
                  interp="bilinear", quantize_bits=8)
        angles = (np.array([0.0, 100.0], np.float32),
                  np.array([10.0, -40.0], np.float32),
                  np.zeros(2, np.float32))
        out = meshlib.warp_frames_sharded(meshlib.data_mesh(devs), frames,
                                          *angles, **kw)
        ref = meshlib.warp_frames_sharded(meshlib.data_mesh(devs[:1]),
                                          frames, *angles, **kw)
        assert out.shape == ref.shape == (batch, 2, 16, 24, 3)
        if batch % 8 == 0:
            assert len(out.sharding.device_set) == 8
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


class TestPipelineDevices:
    def test_cpu_gets_one_device(self):
        from gs360x.runtime import mesh as meshlib

        devs = meshlib.pipeline_devices()
        assert len(devs) == 1 and devs[0].platform == "cpu"

    @pytest.mark.parametrize("platform,count,expect", [
        ("gpu", 4, 4), ("gpu", 1, 1), ("cpu", 8, 1)])
    def test_choice_follows_platform(self, monkeypatch, platform, count,
                                     expect):
        import types

        import jax

        from gs360x.runtime import mesh as meshlib

        fake = [types.SimpleNamespace(platform=platform, id=i)
                for i in range(count)]
        monkeypatch.setattr(jax, "devices", lambda *a: fake)
        assert meshlib.pipeline_devices() == fake[:expect]

    def test_unknown_platform_raises(self, monkeypatch):
        import types

        import jax

        from gs360x.runtime import mesh as meshlib

        monkeypatch.setattr(
            jax, "devices",
            lambda *a: [types.SimpleNamespace(platform="metal", id=0)])
        with pytest.raises(RuntimeError, match="metal"):
            meshlib.pipeline_devices()


class TestMixedViewOrder:
    """A plan mixing projections and sizes comes back in plan order, each
    view equal to its own single-view warp."""

    VIEWS = [
        ViewSpec("A", 0.0, 0.0, 90.0, 90.0, 40, 40),
        ViewSpec("X", 0.0, 0.0, 190.0, 190.0, 32, 32,
                 projection="fisheye_v360"),
        ViewSpec("B", 45.0, 30.0, 90.0, 90.0, 40, 40),
        ViewSpec("S", 90.0, 0.0, 180.0, 180.0, 32, 32,
                 projection="equisolid"),
        ViewSpec("C", -90.0, -20.0, 60.0, 45.0, 24, 16),
        ViewSpec("Y", 180.0, 0.0, 190.0, 190.0, 32, 32,
                 projection="fisheye_v360"),
    ]

    def _single(self, pano, view):
        out = warp.warp_equirect_to_views(
            pano, [view.yaw_deg], [view.pitch_deg], [view.roll_deg],
            width=view.width, height=view.height, hfov_deg=view.hfov_deg,
            vfov_deg=view.vfov_deg, projection=view.projection,
            interp="bicubic")
        return np.rint(np.clip(np.asarray(out[0]), 0, 1) * 255)

    @pytest.mark.parametrize("path", ["warp_plan_views", "executor"])
    def test_order_and_values(self, path):
        from gs360x.runtime import executor
        from gs360x.runtime import mesh as meshlib

        pano = lonlat_pano(128, 64)
        if path == "warp_plan_views":
            outs = [np.rint(np.clip(np.asarray(o), 0, 1) * 255)
                    for o in warp.warp_plan_views(pano, self.VIEWS,
                                                  interp="bicubic")]
        else:
            frame = np.asarray(pano)
            res = executor._warp_frames(
                [frame], self.VIEWS, interp="bicubic",
                mesh=meshlib.data_mesh(meshlib.pipeline_devices()),
                quantize_bits=8)[0]
            outs = [np.asarray(parent)[index] for parent, index in res]
        for view, out in zip(self.VIEWS, outs):
            assert out.shape == (view.height, view.width, 3), view.view_id
            np.testing.assert_allclose(out, self._single(pano, view),
                                       atol=1, err_msg=view.view_id)

    def test_grouping_key_is_static_shape(self):
        groups = warp.group_views(self.VIEWS)
        assert sorted(groups.values()) == [[0, 2], [1, 5], [3], [4]]
