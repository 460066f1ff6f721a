"""Dual-fisheye pipeline tests: calibration math, auto-zoom, SFM10 layout,
lens selection, and the end-to-end CLI on a synthetic rig."""

import math
import pathlib

import numpy as np
import pytest

from gs360x.io import image as im
from gs360x.tools import dualfisheye as df


def make_calib(sid="0", size=512, f=None, **kw):
    f = f if f is not None else size * 0.28  # ~190deg equisolid fill
    return df.SensorCalibration(sensor_id=sid, model_type="fisheye",
                                width=size, height=size, f=f,
                                cx=kw.pop("cx", 0.0), cy=kw.pop("cy", 0.0),
                                **kw)


CALIB_XML = """<?xml version='1.0'?>
<document version="1.2.0">
 <chunk>
  <sensors next_id="2">
   <sensor id="0" label="lensX" type="fisheye">
    <resolution width="512" height="512"/>
    <calibration type="fisheye" class="adjusted">
     <resolution width="512" height="512"/>
     <f>143.0</f><cx>1.5</cx><cy>-0.8</cy><k1>0.01</k1>
    </calibration>
   </sensor>
   <sensor id="1" label="lensY" type="fisheye">
    <resolution width="512" height="512"/>
    <calibration type="fisheye" class="initial">
     <resolution width="512" height="512"/>
     <f>144.0</f>
    </calibration>
   </sensor>
  </sensors>
  <cameras next_id="2">
   <camera id="0" label="frame_0001_X" sensor_id="0"/>
   <camera id="1" label="frame_0001_Y" sensor_id="1"/>
  </cameras>
 </chunk>
</document>"""


@pytest.fixture
def calib_xml(tmp_path):
    p = tmp_path / "calib.xml"
    p.write_text(CALIB_XML)
    return p


REFERENCE_OSMO_XML = pathlib.Path(
    "/root/reference/cli_tools/templates/Osmo360-Fisheye-Distortion.xml")


class TestReferenceCalibrationCompat:
    """Real Metashape Osmo 360 exports (type=equisolid_fisheye) must load
    and produce undistortion maps matching the reference's equisolid +
    Brown math (gs360_DualFisheyeDistortionCalibration.py:49,767-828,
    1008-1051)."""

    @pytest.fixture
    def osmo_calib(self):
        if not REFERENCE_OSMO_XML.is_file():
            pytest.skip("reference template not available")
        sensors, cam_map = df.load_metashape_calibration(REFERENCE_OSMO_XML)
        return sensors, cam_map

    def test_loads_adjusted_equisolid_class(self, osmo_calib):
        sensors, cam_map = osmo_calib
        assert "0" in sensors
        c = sensors["0"]
        assert c.model_type == "equisolid_fisheye"
        assert c.width == 3840 and c.height == 3840
        # adjusted class preferred over the initial f=1050
        assert abs(c.f - 1049.9268186384606) < 1e-9
        assert abs(c.k1 - 0.10190869149858893) < 1e-12
        assert cam_map.get("Osmo360_DualFisheye_0000000_X") == "0"

    def test_remap_cache_accepts_equisolid(self, osmo_calib):
        sensors, _ = osmo_calib
        cache = df.build_remap_cache(sensors["0"], 1.1, 190.0)
        assert cache.map_x.shape == (3840, 3840)
        assert cache.valid.any()

    def test_undistortion_math_matches_reference(self, osmo_calib):
        # independent recomputation of the reference's map (:1008-1051):
        # normalize about the principal point, divide by zoom, apply the
        # Brown radial polynomial, project back through f/b1/b2
        sensors, _ = osmo_calib
        c = sensors["0"]
        zoom = 1.25
        rng = np.random.default_rng(3)
        dx = rng.uniform(0, c.width - 1, 64)
        dy = rng.uniform(0, c.height - 1, 64)
        sx, sy, valid, vm = df.remap_for_zoom(c, dx, dy, zoom, 190.0)

        cx0 = c.width * 0.5 + c.cx
        cy0 = c.height * 0.5 + c.cy
        y0 = (dy - cy0) / c.f
        x0 = (dx - cx0 - y0 * c.b2) / (c.f + c.b1)
        x, y = x0 / zoom, y0 / zoom
        r2 = x * x + y * y
        radial = 1.0 + c.k1 * r2 + c.k2 * r2**2 + c.k3 * r2**3 + c.k4 * r2**4
        exp_sx = cx0 + x * radial * (c.f + c.b1) + y * radial * c.b2
        exp_sy = cy0 + y * radial * c.f
        np.testing.assert_allclose(sx, exp_sx, rtol=1e-12)
        np.testing.assert_allclose(sy, exp_sy, rtol=1e-12)
        theta = 2.0 * np.arcsin(np.clip(np.sqrt(r2) * 0.5, 0.0, 1.0))
        np.testing.assert_array_equal(vm, theta <= math.radians(95.0))

    def test_center_pixel_fixed_point(self, osmo_calib):
        # the principal point is invariant under undistortion at any zoom
        sensors, _ = osmo_calib
        c = sensors["0"]
        cx0 = c.width * 0.5 + c.cx
        cy0 = c.height * 0.5 + c.cy
        sx, sy, _, _ = df.remap_for_zoom(
            c, np.array([cx0]), np.array([cy0]), 1.5, 190.0)
        assert abs(sx[0] - cx0) < 1e-9 and abs(sy[0] - cy0) < 1e-9


class TestGeneratedTemplate:
    def test_generated_default_matches_reference_constants(self, tmp_path):
        from gs360x import templates

        path = templates.write_osmo360_default_calibration(
            tmp_path / "osmo.xml")
        sensors, _ = df.load_metashape_calibration(path)
        c = sensors["0"]
        assert c.model_type == "equisolid_fisheye"
        assert abs(c.f - templates.OSMO360_ADJUSTED["f"]) < 1e-9
        assert abs(c.k1 - templates.OSMO360_ADJUSTED["k1"]) < 1e-12
        assert abs(c.cx - templates.OSMO360_ADJUSTED["cx"]) < 1e-12
        # and it passes the model gate
        df.build_remap_cache(c, 1.2, 190.0)

    def test_unsupported_model_rejected(self):
        c = make_calib(size=64)
        c.model_type = "frame"
        with pytest.raises(ValueError, match="Unsupported sensor model"):
            df.build_remap_cache(c, 1.0, 190.0)


class TestCalibration:
    def test_load_prefers_adjusted(self, calib_xml):
        sensors, cam_map = df.load_metashape_calibration(calib_xml)
        assert sorted(sensors) == ["0", "1"]
        assert sensors["0"].f == 143.0 and sensors["0"].k1 == 0.01
        assert cam_map["frame_0001_X"] == "0"

    def test_remap_identity_at_center(self):
        c = make_calib()
        cx0, cy0 = c.center
        sx, sy, valid, _ = df.remap_for_zoom(
            c, np.array([[cx0]]), np.array([[cy0]]), 1.0, 190.0)
        assert sx[0, 0] == pytest.approx(cx0, abs=1e-6)
        assert sy[0, 0] == pytest.approx(cy0, abs=1e-6)
        assert valid[0, 0]

    def test_auto_zoom_no_distortion_is_one(self):
        c = make_calib(f=100.0)
        assert df.estimate_auto_undistort_zoom(c) == 1.0

    def test_auto_zoom_positive_distortion(self):
        c = make_calib(f=140.0, k1=0.15)
        z = df.estimate_auto_undistort_zoom(c)
        assert z > 1.0
        # at the found zoom, all valid samples are in bounds
        gx = np.linspace(0, c.width - 1, 64)
        sx, sy, _v, vm = df.remap_for_zoom(
            c, *np.meshgrid(gx, gx), z, 190.0)
        assert sx[vm].min() >= -0.51 and sx[vm].max() <= c.width - 0.49


class TestSfm10:
    def test_layout_ids(self):
        specs = df.build_sfm10_specs(256, 14.0, "36 36", 40.0, 40.0)
        assert [s["view_id"] for s in specs] == [
            "A", "A_U", "A_D", "B", "E", "F", "F_U", "F_D", "G", "J"]

    def test_bad_deltas_rejected(self):
        with pytest.raises(ValueError):
            df.build_sfm10_specs(256, 14.0, "36 36", 190.0, 40.0)
        with pytest.raises(ValueError):
            df.build_sfm10_specs(256, 14.0, "36 36", 40.0, 95.0)

    def test_lens_selection_front_back(self):
        sensors = {"0": make_calib("0"), "1": make_calib("1")}
        specs = df.build_sfm10_specs(64, 14.0, "36 36", 40.0, 40.0)
        maps = df.build_perspective_spec_maps(sensors, "0", "1", specs,
                                              0.0, 180.0, 190.0)
        assert maps["A"]["lens_key"] == "X"   # front view -> front lens
        assert maps["F"]["lens_key"] == "Y"   # back view -> back lens

    def test_direct_map_center_view_hits_lens_center(self):
        c = make_calib()
        mx, my, valid = df.build_direct_perspective_map(
            c, 0.0, 0.0, 90.0, 90.0, 65, 65, 190.0)
        cx0, cy0 = c.center
        assert mx[32, 32] == pytest.approx(cx0, abs=1.0)
        assert my[32, 32] == pytest.approx(cy0, abs=1.0)
        assert valid.mean() > 0.9


class TestPairing:
    def test_build_pairs(self, tmp_path):
        for name in ("a_X.jpg", "a_Y.jpg", "b_X.jpg", "c_Y.jpg", "d.jpg"):
            (tmp_path / name).touch()
        files = sorted(tmp_path.iterdir())
        pairs = df.build_pair_records(files, "_X", "_Y")
        assert [p[0] for p in pairs] == ["a"]


def synth_fisheye(calib, seed=0):
    """Synthetic fisheye capture: horizontal gradient in the valid circle."""
    h, w = calib.height, calib.width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx0, cy0 = calib.center
    r = np.sqrt((xx - cx0) ** 2 + (yy - cy0) ** 2) / (2.0 * calib.f)
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = np.clip(xx / w, 0, 1)
    img[..., 1] = np.clip(yy / h, 0, 1)
    img[..., 2] = 0.5
    img[r > 1.0] = 0.0
    return (img * 255).astype(np.uint8)


class TestCli:
    def test_end_to_end(self, calib_xml, tmp_path, capsys):
        sensors, _ = df.load_metashape_calibration(calib_xml)
        in_dir = tmp_path / "pairs"
        in_dir.mkdir()
        im.write_image(in_dir / "frame_0001_X.png", synth_fisheye(sensors["0"]))
        im.write_image(in_dir / "frame_0001_Y.png", synth_fisheye(sensors["1"]))
        out = tmp_path / "out"
        rc = df.main(["--input-dir", str(in_dir), "--camera-xml",
                      str(calib_xml), "--output-dir", str(out),
                      "--perspective-size", "128",
                      "--save-fisheye-output",
                      "--report-json", str(tmp_path / "r.json")])
        assert rc == 0
        persp = sorted((out / "perspective" / "images").glob("*.jpg"))
        assert len(persp) == 10
        assert (out / "frame_0001_X.png").exists()  # undistorted fisheye
        img = im.read_image(persp[0])
        assert img.shape == (128, 128, 3)
        assert img.mean() > 5  # not all fill

    def test_dry_run(self, calib_xml, tmp_path, capsys):
        in_dir = tmp_path / "pairs"
        in_dir.mkdir()
        (in_dir / "p_X.jpg").write_bytes(b"")
        (in_dir / "p_Y.jpg").write_bytes(b"")
        rc = df.main(["--input-dir", str(in_dir), "--camera-xml",
                      str(calib_xml), "--dry-run",
                      "--perspective-size", "64"])
        assert rc == 0
        assert "[DRY]" in capsys.readouterr().out

    def test_metadata_only(self, calib_xml, tmp_path):
        ext_xml = tmp_path / "align.xml"
        ext_xml.write_text("""<?xml version='1.0'?>
<document><chunk>
 <sensors next_id="1"><sensor id="0" type="fisheye"/></sensors>
 <cameras next_id="2">
  <camera id="0" label="frame_0001_X">
   <transform>1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1</transform>
  </camera>
  <camera id="1" label="frame_0001_Y">
   <transform>-1 0 0 0 0 1 0 0 0 0 -1 0 0 0 0 1</transform>
  </camera>
 </cameras>
</chunk></document>""")
        out = tmp_path / "meta"
        rc = df.main(["--camera-xml", str(calib_xml), "--metadata-only",
                      "--camera-extrinsics-xml", str(ext_xml),
                      "--output-dir", str(out),
                      "--perspective-size", "64"])
        assert rc == 0
        from gs360x.io.formats import colmap_text
        model = colmap_text.read_model(out / "sparse" / "0")
        assert len(model.images) == 10  # one rig pose x 10 views

    def test_missing_xml(self, tmp_path, capsys):
        rc = df.main(["--camera-xml", str(tmp_path / "no.xml")])
        assert rc == 1


def _keys_weights(t, a=-0.5):
    """Keys cubic-convolution weights of the taps at offsets -1, 0, 1, 2
    from floor(u), written from the kernel's piecewise definition."""
    out = []
    for off in (-1, 0, 1, 2):
        x = np.abs(t - off)
        near = (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
        far = a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a
        out.append(np.where(x <= 1, near, np.where(x < 2, far, 0.0)))
    return out


def numpy_remap(img, map_x, map_y, valid, interp, fill):
    """Independent float64 remap with clamped borders (cv2.remap with
    BORDER_REPLICATE semantics) and ``fill`` outside ``valid``."""
    h, w = img.shape[:2]
    u = map_x.astype(np.float64)
    v = map_y.astype(np.float64)
    x0, y0 = np.floor(u).astype(int), np.floor(v).astype(int)
    tx, ty = u - x0, v - y0
    if interp == "bilinear":
        offs, wx, wy = (0, 1), [1 - tx, tx], [1 - ty, ty]
    else:
        offs, wx, wy = (-1, 0, 1, 2), _keys_weights(tx), _keys_weights(ty)
    out = np.zeros(u.shape + img.shape[2:])
    for i, dy in enumerate(offs):
        yi = np.clip(y0 + dy, 0, h - 1)
        for j, dx in enumerate(offs):
            xi = np.clip(x0 + dx, 0, w - 1)
            wgt = wx[j] * wy[i]
            out += (wgt[..., None] if img.ndim == 3 else wgt) * img[yi, xi]
    mask = valid[..., None] if img.ndim == 3 else valid
    return np.where(mask, out, fill)


class TestDeviceRemap:
    """``device_remap`` (the dual-fisheye CLI's device path) against the
    independent numpy remap, on one lens's SFM10 views."""

    LENS_PX, VIEW_PX, FILL = 256, 40, 0.3

    def _maps(self, view_id):
        calib = make_calib(size=self.LENS_PX)
        spec = next(s for s in df.build_sfm10_specs(
            self.VIEW_PX, 12.0, "36 36", 45.0, 45.0)
            if s["view_id"] == view_id)
        return df.build_direct_perspective_map(
            calib, df.wrap_angle_deg(spec["yaw_deg"]), spec["pitch_deg"],
            spec["hfov_deg"], spec["vfov_deg"], self.VIEW_PX, self.VIEW_PX,
            190.0)

    @pytest.mark.parametrize("interp", ["catmull-rom", "bilinear"])
    @pytest.mark.parametrize("view_id", ["A", "A_U", "A_D", "B", "J"])
    def test_matches_numpy_remap(self, view_id, interp):
        mx, my, valid = self._maps(view_id)
        assert valid.any()
        valid[:5] = False    # a fill band in every view
        rng = np.random.default_rng(3)
        img = rng.random((self.LENS_PX, self.LENS_PX, 3)).astype(np.float32)
        got = df.device_remap(img, mx, my, valid, interp=interp,
                              fill=self.FILL, quantize=True)
        want = numpy_remap(img, mx, my, valid, interp, self.FILL)
        want_u8 = np.rint(np.clip(want, 0, 1) * 255).astype(np.int32)
        assert got.dtype == np.uint8
        assert got.shape == (self.VIEW_PX, self.VIEW_PX, 3)
        assert np.abs(got.astype(np.int32) - want_u8).max() <= 1
        assert np.all(got[~valid] == round(self.FILL * 255))

    def test_gray_mask_keeps_2d_shape(self):
        mx, my, valid = self._maps("A")
        mask = (np.random.default_rng(4).random(
            (self.LENS_PX, self.LENS_PX)) > 0.5).astype(np.float32)
        got = df.device_remap(mask, mx, my, valid, interp="nearest",
                              fill=0.0)
        assert got.shape == (self.VIEW_PX, self.VIEW_PX)
        assert set(np.unique(got)) <= {0.0, 1.0}
