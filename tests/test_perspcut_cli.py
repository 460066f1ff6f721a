"""End-to-end CLI tests for gs360x-perspcut (image dir + video modes)."""

import math

import numpy as np
import pytest

from gs360x.io import image as im
from gs360x.io import video as vio
from gs360x.tools import perspcut


def make_pano(w=256, h=128):
    """uint8 panorama with a smooth wrap-periodic longitude signal."""
    xs = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ys = (2.0 * np.arange(h) + 1.0) / h - 1.0
    lon, lat = np.meshgrid(xs * math.pi, ys * math.pi / 2)
    img = np.stack([
        0.5 + 0.5 * np.sin(lon),
        0.5 + 0.5 * np.sin(lat),
        np.full_like(lon, 0.25),
    ], axis=-1)
    return (img * 255).astype(np.uint8)


@pytest.fixture
def pano_dir(tmp_path):
    d = tmp_path / "panos"
    d.mkdir()
    im.write_image(d / "pano_0001.png", make_pano())
    im.write_image(d / "pano_0002.png", make_pano())
    return d


class TestImageMode:
    def test_default_preset_writes_8_views_each(self, pano_dir, tmp_path, capsys):
        out = tmp_path / "out"
        rc = perspcut.main(["-i", str(pano_dir), "-o", str(out),
                            "--size", "64", "--ext", "png"])
        assert rc == 0
        names = sorted(p.name for p in out.iterdir())
        assert names == sorted(
            f"pano_{i:04d}_{v}.png" for i in (1, 2) for v in "ABCDEFGH")
        a = im.read_image(out / "pano_0001_A.png")
        assert a.shape == (64, 64, 3)
        # view A looks at yaw 0: longitude channel sin(0)=0 -> 127/128
        center = a[31:33, 31:33, 0].astype(float).mean()
        assert abs(center - 127.5) < 3
        captured = capsys.readouterr()
        assert "[OK] Completed: success=16" in captured.out
        assert "For Metashape" in captured.out

    def test_png_run_needs_no_pil(self, pano_dir, tmp_path, monkeypatch,
                                  capsys):
        import sys

        monkeypatch.setitem(sys.modules, "PIL", None)
        out = tmp_path / "out"
        rc = perspcut.main(["-i", str(pano_dir), "-o", str(out), "--size",
                            "32", "--ext", "png"])
        assert rc == 0
        files = sorted(out.glob("*.png"))
        assert len(files) == 16
        assert im.read_image(files[0]).shape == (32, 32, 3)

    def test_dry_run_prints_plan(self, pano_dir, tmp_path, capsys):
        rc = perspcut.main(["-i", str(pano_dir), "--dry-run",
                            "--preset", "fisheyelike"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "[DRY] Exiting without execution (total 20 commands)" in out
        assert "pano_0001_A_U.jpg" in out

    def test_default_out_dir_is_geometry(self, pano_dir, capsys):
        rc = perspcut.main(["-i", str(pano_dir), "--size", "32",
                            "--ext", "png", "--count", "2"])
        assert rc == 0
        assert (pano_dir / "_geometry" / "pano_0001_A.png").exists()

    def test_no_overwrite_skips(self, pano_dir, tmp_path, capsys):
        out = tmp_path / "out"
        args = ["-i", str(pano_dir), "-o", str(out), "--size", "32",
                "--ext", "png", "--count", "2"]
        assert perspcut.main(args) == 0
        assert perspcut.main(args + ["--no-overwrite"]) == 0
        assert "skipped=4" in capsys.readouterr().out

    def test_empty_dir_warns(self, tmp_path, capsys):
        d = tmp_path / "empty"
        d.mkdir()
        assert perspcut.main(["-i", str(d)]) == 0
        assert "No target images" in capsys.readouterr().err

    def test_missing_input_errors(self, tmp_path, capsys):
        assert perspcut.main(["-i", str(tmp_path / "nope")]) == 1


class TestVideoMode:
    def test_video_export(self, tmp_path, capsys):
        clip = tmp_path / "clip.y4m"
        frames = [make_pano(128, 64) for _ in range(10)]
        vio.write_y4m(clip, frames, fps=10.0)
        out = tmp_path / "vid_out"
        rc = perspcut.main(["-i", str(clip), "-o", str(out), "-f", "5",
                            "--size", "32", "--ext", "png", "--count", "4"])
        assert rc == 0
        names = sorted(p.name for p in out.iterdir())
        # 1s clip at 5fps -> ticks 0.0..0.8 -> 5 frames (x 4 views)
        assert len(names) == 20
        assert "clip_0000000_A.png" in names
        assert "clip_0000004_D.png" in names

    def test_select_csv_filters_frames(self, tmp_path):
        # FrameSelector-CSV replay: only rows flagged selected export,
        # keeping original frame numbering (gs360_GUI.py:19081-19148)
        import csv

        clip = tmp_path / "clip.y4m"
        vio.write_y4m(clip, [make_pano(128, 64) for _ in range(10)],
                      fps=10.0)
        sel = tmp_path / "sel.csv"
        with open(sel, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["index", "input_mode", "filename", "pair_base",
                        "x_filename", "y_filename", "score",
                        "brightness_mean", "group_score", "flow_motion",
                        "selected(1=keep)"])
            for i in range(5):
                w.writerow([i, "single", f"out_{i:07d}.jpg", "", "", "",
                            0.5, 0.5, 1.0, 0.0, 1 if i in (1, 3) else 0])
        out = tmp_path / "sel_out"
        rc = perspcut.main(["-i", str(clip), "-o", str(out), "-f", "5",
                            "--size", "32", "--ext", "png", "--count", "2",
                            "--select-csv", str(sel)])
        assert rc == 0
        names = sorted(p.name for p in out.iterdir())
        assert names == ["clip_0000001_A.png", "clip_0000001_B.png",
                         "clip_0000003_A.png", "clip_0000003_B.png"]

    def test_select_csv_rejects_image_mode(self, tmp_path, capsys):
        d = tmp_path / "imgs"
        d.mkdir()
        im.write_image(d / "a.jpg", make_pano(64, 32))
        rc = perspcut.main(["-i", str(d), "--select-csv", "x.csv"])
        assert rc == 1
        assert "video inputs only" in capsys.readouterr().err

    def test_video_requires_fps(self, tmp_path, capsys):
        clip = tmp_path / "clip.y4m"
        vio.write_y4m(clip, [make_pano(64, 32)], fps=10.0)
        assert perspcut.main(["-i", str(clip)]) == 1
        assert "fps must be specified" in capsys.readouterr().err

    def test_video_color_move_applied(self, tmp_path):
        # a mid-gray Rec709 pano should brighten when re-encoded as sRGB
        clip = tmp_path / "gray.y4m"
        gray = np.full((64, 128, 3), 100, np.uint8)
        vio.write_y4m(clip, [gray] * 2, fps=2.0)
        out = tmp_path / "gray_out"
        rc = perspcut.main(["-i", str(clip), "-o", str(out), "-f", "2",
                            "--size", "32", "--ext", "png", "--count", "1"])
        assert rc == 0
        img = im.read_image(out / "gray_0000000_A.png")
        assert img.mean() > 102  # sRGB re-encode lifts mid tones
