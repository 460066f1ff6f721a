"""Headless GUI tests: argv builders, overlay math, settings, runner."""

import math
import sys
import time

import numpy as np
import pytest

from gs360x.gui import forms, overlay
from gs360x.gui.runner import ProcessRunner, tool_argv
from gs360x.gui.settings import Settings
from gs360x.rig.spec import ViewSpec


class TestArgvBuilders:
    def test_video2frames(self):
        argv = forms.build_video2frames_argv(
            {"video": "/v.y4m", "fps": 2.5, "output": "/o",
             "keep_rec709": True, "map_stream": "0:v:1"})
        assert argv[:4] == ["-i", "/v.y4m", "-f", "2.5"]
        assert "--keep-rec709" in argv
        assert argv[argv.index("--map-stream") + 1] == "0:v:1"

    def test_defaults_omitted(self):
        argv = forms.build_perspcut_argv(
            {"input_dir": "/p", "preset": "default", "count": 8,
             "size": 1600, "focal_mm": 12.0, "ext": "jpg"})
        assert argv == ["-i", "/p"]

    def test_perspcut_overrides(self):
        argv = forms.build_perspcut_argv(
            {"input_dir": "/p", "preset": "fisheyelike", "size": 2000,
             "setcam": "A=10", "add_top": True})
        assert "--preset" in argv and "fisheyelike" in argv
        assert argv[argv.index("--size") + 1] == "2000"
        assert "--add-top" in argv

    def test_dualfisheye_extract_queue(self):
        jobs = forms.build_dualfisheye_extract_queue(
            {"video": "/c.mp4", "fps": 2.0})
        assert len(jobs) == 2
        assert jobs[0][jobs[0].index("--map-stream") + 1] == "0:v:1"
        assert jobs[0][jobs[0].index("--name-suffix") + 1] == "_Y"
        assert jobs[1][jobs[1].index("--name-suffix") + 1] == "_X"

    def test_camconvert_per_format_input_flag(self):
        argv = forms.build_camconvert_argv(
            {"cmd": "colmap", "input": "/cm", "out": "/o"})
        assert argv[:2] == ["colmap", "/cm"]
        argv = forms.build_camconvert_argv(
            {"cmd": "realityscan-csv", "input": "/a.csv", "out": "/o",
             "width": 1600, "height": 1600})
        assert "--csv" in argv and "--width" in argv

    def test_all_tabs_build(self):
        samples = {
            "video2frames": {"video": "/v", "fps": 1},
            "frameselector": {"in_dir": "/d"},
            "perspcut": {"input_dir": "/d"},
            "maskseg": {"input_dir": "/d"},
            "plyopt": {"input": "/c.ply"},
            "ms360xml": {"xml": "/x.xml"},
            "dualfisheye": {"camera_xml": "/c.xml"},
            "camconvert": {"cmd": "colmap", "input": "/cm", "out": "/o"},
            "scene": {"source": "/s"},
        }
        for _title, module, _fields, build in forms.TABS:
            argv = build(samples[module])
            assert isinstance(argv, list) and argv

    def test_tool_argv_launches_module(self):
        argv = tool_argv("perspcut", ["-i", "/p"])
        assert argv[0] == sys.executable
        assert argv[1:4] == ["-m", "gs360x.tools.perspcut", "-i"]


class TestOverlay:
    def test_front_view_centered(self):
        view = ViewSpec("A", 0.0, 0.0, 90.0, 90.0, 100, 100)
        ov = overlay.view_overlay(view, 1000, 500)
        assert ov.label_xy[0] == pytest.approx(499.5, abs=1)
        assert ov.label_xy[1] == pytest.approx(249.5, abs=1)
        # 90° view spans a quarter of the pano width at the equator
        xs = np.concatenate([s[:, 0] for s in ov.segments])
        assert 200 < xs.max() - xs.min() < 420

    def test_seam_view_splits(self):
        view = ViewSpec("E", 180.0, 0.0, 90.0, 90.0, 100, 100)
        ov = overlay.view_overlay(view, 1000, 500)
        assert len(ov.segments) >= 2  # border crosses the seam

    def test_fisheye_circle(self):
        view = ViewSpec("X", 0.0, 0.0, 180.0, 180.0, 100, 100,
                        projection="fisheye_v360")
        ov = overlay.view_overlay(view, 1000, 500)
        ys = np.concatenate([s[:, 1] for s in ov.segments])
        assert ys.min() < 20 and ys.max() > 480  # 180° circle spans poles

    def test_plan_overlays_count(self):
        views = [ViewSpec(t, i * 45.0, 0.0, 90.0, 90.0, 10, 10)
                 for i, t in enumerate("ABCD")]
        assert len(overlay.plan_overlays(views, 800, 400)) == 4


class TestSettings:
    def test_round_trip(self, tmp_path):
        s = Settings(tmp_path / "cfg.json")
        s.set("theme", "dark")
        s.update_tab("perspcut", {"size": 2048})
        s.save()
        s2 = Settings(tmp_path / "cfg.json")
        assert s2.get("theme") == "dark"
        assert s2.tab("perspcut")["size"] == 2048

    def test_corrupt_file_ignored(self, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text("{not json")
        s = Settings(p)
        assert s.tab("x") == {}


class TestRunner:
    def test_streams_and_completes(self):
        runner = ProcessRunner()
        lines = []
        done = []
        ok = runner.run("t", [sys.executable, "-c",
                              "print('hello'); print('world')"],
                        lines.append, done.append)
        assert ok
        for _ in range(600):  # generous under load
            if done:
                break
            time.sleep(0.05)
        assert done == [0]
        joined = "".join(lines)
        assert "hello" in joined and "world" in joined

    def test_single_flight(self):
        runner = ProcessRunner()
        lines = []
        runner.run("k", [sys.executable, "-c", "import time; time.sleep(2)"],
                   lines.append)
        assert not runner.run("k", [sys.executable, "-c", "pass"],
                              lines.append)
        assert runner.stop("k")

    def test_one_run_at_a_time_across_keys(self):
        # every tool is a JAX process that reserves most of the card
        runner = ProcessRunner()
        lines = []
        assert runner.run("a", [sys.executable, "-c",
                                "import time; time.sleep(2)"], lines.append)
        assert runner.running_key() == "a"
        assert not runner.run("b", [sys.executable, "-c", "pass"],
                              lines.append)
        assert not runner.run_queue("c", [[sys.executable, "-c", "pass"]],
                                    lines.append)
        assert "a is already running" in "".join(lines)
        assert runner.stop("a")

    def test_queue_sequential(self):
        runner = ProcessRunner()
        lines = []
        done = []
        runner.run_queue("q", [
            [sys.executable, "-c", "print('one')"],
            [sys.executable, "-c", "print('two')"],
        ], lines.append, done.append)
        for _ in range(600):  # generous under load
            if done:
                break
            time.sleep(0.05)
        joined = "".join(lines)
        assert done == [0]
        assert joined.index("one") < joined.index("two")

    def test_queue_aborts_on_failure(self):
        runner = ProcessRunner()
        lines = []
        done = []
        runner.run_queue("q2", [
            [sys.executable, "-c", "raise SystemExit(3)"],
            [sys.executable, "-c", "print('never')"],
        ], lines.append, done.append)
        for _ in range(600):  # generous under load
            if done:
                break
            time.sleep(0.05)
        assert done == [3]
        assert "never" not in "".join(lines)
