"""The harness's arithmetic and discovery, on the CPU.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from portbench.harness import core, guard, stats, trace  # noqa: E402
from portbench.harness.peaks import HBM_BYTES_PER_S, PEAK_FLOPS, bound_s  # noqa: E402


def _run(records=None, tr=None, cfg=None, window_s=10.0):
    run = core.Run("x", cfg or {}, {}, 0, None)
    run.records = records or {}
    run.window_s = window_s
    run.tracer = types.SimpleNamespace(result=tr)
    return run


def test_p95_is_taken_over_every_tick():
    ticks = [{"ms": float(v)} for v in range(1, 101)]
    mod = core.reader("tick_p95_ms")
    # sorted values, index min(int(0.95 n), n - 1): the 96th of 100
    assert mod.read(_run({"ticks": ticks})) == 96.0
    assert stats.quantile([5.0], 0.95) == 5.0
    assert stats.quantile([], 0.95) is None
    shuffled = ticks[::-1]
    assert mod.read(_run({"ticks": shuffled})) == 96.0


def test_idle_share_is_one_minus_the_union_of_device_intervals():
    # two overlapping kernels, a copy inside one of them, a memset apart
    dev = [("k1", 0.0, 4.0), ("k2", 2.0, 6.0), ("memcpy", 3.0, 5.0),
           ("memset", 8.0, 9.0)]
    tr = trace.Trace.from_events(dev, [("pool.step", 0.0, 7.5), ("pool.read", 6.0, 7.5)], 10.0, 1)
    assert tr.busy_s == pytest.approx(7.0)          # [0, 6] and [8, 9]
    mod = core.reader("device.idle_share")
    assert mod.read(_run(tr=tr)) == pytest.approx(30.0)
    # a metric with no reader of its own is read by its prefix's
    assert core.reader("device.idle_share.openloop").__file__ == mod.__file__
    assert core.reader("loop.ms_per_iter.openloop").__file__.endswith("loop.ms_per_iter.py")
    with pytest.raises(FileNotFoundError):
        core.reader("nothing.here")
    assert trace.union_length([]) == 0.0
    assert trace.gaps([(1.0, 2.0)], 0.0, 3.0) == [(0.0, 1.0), (2.0, 3.0)]
    gaps = dict(tr.idle_gaps())
    # the gap (6, 8) falls in pool.read, the innermost span over its middle
    assert gaps["pool.read (1 gaps)"] == pytest.approx(2.0)
    assert gaps["outside every span (1 gaps)"] == pytest.approx(1.0)
    assert tr.top_ops()[0] == ["k1", 4.0]


def test_a_device_loop_launch_counts_its_unrecorded_iterations():
    """One graph launch: pre, loop_start, one recorded body iteration (2
    kernels and loop_next, 1 s), 3 s of unrecorded iterations, post; a
    plain kernel after it."""
    ev = [("pre", 0.0, 0.5), ("void loop_start(...)", 0.5, 0.6), ("body_a", 0.6, 1.0),
          ("body_b", 1.0, 1.5), ("void loop_next(...)", 1.5, 1.6), ("post", 4.6, 5.0),
          ("plain", 6.0, 7.0)]
    tr = trace.Trace.from_events(ev, [], 8.0, 1)
    assert tr.busy_s == pytest.approx(6.0)            # [0, 5] and [6, 7]
    # the loop's span (0.6 to 4.6) is four recorded iterations' worth
    assert tr.device_time(lambda n: n == "body_a") == pytest.approx(1.6)
    assert tr.device_time(lambda n: n == "body_b") == pytest.approx(2.0)
    assert tr.device_time(lambda n: n in ("pre", "post", "plain")) == pytest.approx(1.9)
    # the last iteration recorded, the first three not
    ev = [("pre", 0.0, 0.5), ("void loop_start(...)", 0.5, 0.6), ("body_a", 3.6, 4.0),
          ("body_b", 4.0, 4.5), ("void loop_next(...)", 4.5, 4.6), ("post", 4.6, 5.0)]
    tr = trace.Trace.from_events(ev, [], 8.0, 1)
    assert tr.busy_s == pytest.approx(5.0)
    assert tr.device_time(lambda n: n == "body_a") == pytest.approx(1.6)
    # a launch whose lanes all started done: no loop_next, nothing scaled
    tr = trace.Trace.from_events([("pre", 0.0, 0.5), ("void loop_start(...)", 0.5, 0.6),
                                  ("post", 0.6, 1.0)], [], 2.0, 1)
    assert tr.busy_s == pytest.approx(1.0) and tr.device_time(lambda n: True) == pytest.approx(1.0)


def test_roofline_from_the_frozen_counts():
    cfg = core.load_json("configs", "demo9.json")
    c = cfg["al_solve_per_lane_iteration"]
    lane_iters = 1024 * 40
    t_al = 0.004
    tr = trace.Trace.from_events([("void newton_al_solve_kernel<float, true, 3>(...)", 0.0, t_al),
                                  ("newton_assemble_kernel", t_al, 0.01)], [], 0.02, 1)
    mod = core.reader("kernels.roofline.al_solve")
    got = mod.read(_run({"traced_lane_iters": lane_iters}, tr, cfg))
    least = max(lane_iters * c["bytes"] / HBM_BYTES_PER_S,
                lane_iters * c["flops"] / PEAK_FLOPS["float32"])
    assert got == pytest.approx(100.0 * least / t_al)
    assert bound_s(3.35e12, 0.0)[1] == "bytes"
    # nothing to read: no traced ticks or no AL solve kernel in the trace
    assert mod.read(_run({}, tr, cfg)) is None
    tr2 = trace.Trace.from_events([("other", 0.0, 1.0)], [], 1.0, 1)
    assert mod.read(_run({"traced_lane_iters": 5}, tr2, cfg)) is None


def test_spd_share_and_rates_read_their_records():
    tr = trace.Trace.from_events([("void spdb_panel_kernel<float>(...)", 0.0, 1.0),
                                  ("x", 1.0, 4.0)], [], 5.0, 1)
    assert core.reader("kernels.spd_inv_blocked_share.openloop").read(
        _run(tr=tr)) == pytest.approx(25.0)
    rate = core.reader("replans_per_s")
    assert rate.read(_run({"replans": 3000}, window_s=3.0)) == pytest.approx(1000.0)
    assert rate.read(_run({}, window_s=3.0)) is None
    per_iter = core.reader("loop.ms_per_iter")
    assert per_iter.read(_run({"solves": [(0.03, 10), (0.05, 30)]})) == pytest.approx(2.0)
    assert core.reader("ipm.iters_per_plan.openloop").read(
        _run({"solves": [(0.03, 10), (0.05, 30)]})) == pytest.approx(20.0)
    plan = core.reader("openloop_plan_ms")
    assert plan.read(_run({"plans": [{}] * 4}, window_s=2.0)) == pytest.approx(500.0)
    prof = [{"free": (10, 50, 0.2), "qr6": (2, 100, 0.3)}, {"qr8": (1, 100, 0.5)}]
    share = core.reader("ladder.qr_rescue_share")
    assert share.read(_run({"rung_profile": prof})) == pytest.approx(80.0)
    per = core.reader("rollout.iters_per_replan")
    assert per.read(_run({"rung_profile": prof, "replans": 25})) == pytest.approx(10.0)


PARKED = sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, "parked")) if f.endswith(".json"))


@pytest.mark.parametrize("cell", [None] + PARKED)
def test_manifest_names_every_file_and_each_metric_has_a_reader(cell):
    """The manifest, and the manifest with each parked cell put back."""
    from portbench.tests.cpu import parked

    m = parked(cell) if cell else core.load_manifest()
    names = [w["name"] for w in m["workloads"]]
    assert len(names) == len(set(names))
    assert cell is None or cell in names
    metrics = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for c in m["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
    for w in m["workloads"]:
        cfg = core.load_json("configs", f"{w['config']}.json")
        tr = core.load_json("traffic", f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(BENCH, "kinds", f"{tr['kind']}.py"))
        assert cfg["name"] == w["config"]
        # every cell reports setup_s, another end-to-end metric, a per-layer one
        e2e = [x["name"] for x in core.metrics_for(m, w["name"], 0)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = core.metrics_for(m, w["name"], 1)
        assert layer and all(x["moves"] in e2e for x in layer)
    for x in m["end_to_end"] + m["per_layer"]:
        assert hasattr(core.reader(x["name"]), "read")


def test_a_cell_config_traffic_and_metric_added_as_files_are_found(tmp_path):
    """A later PR adds a cell by files and a manifest entry alone: here a
    configuration on a map of its own (a 20 x 24 room with one block),
    carried by its file only."""
    root = tmp_path / "co"
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    m = core.load_manifest()
    cfg = core.load_json("configs", "demo9.json")
    cfg["name"] = "demo9_tiny"
    cfg["world"] = {
        "name": "room", "x_lo": [0.0, 0.0], "x_hi": [20.0, 24.0], "start": [2.0, 3.0, 0.0],
        "goal": [17.0, 21.0, 1.5707963267948966],
        "static_lobs": [[[8.0, 8.0], [8.0, 14.0], [13.0, 14.0], [13.0, 8.0], [8.0, 8.0]]],
        "grid_rects": [[[8.0, 8.0], [8.0, 14.0], [13.0, 14.0], [13.0, 8.0]]],
        "dyn_obs_info": [[3.0, 20.0, 0.0, 2.0, 2.0, 0.3, 3.0, 20.0, 0.0, 0.0, 100.0]],
        "terminal_set": [[14.0, 20.0], [18.0, 24.0]], "ts_base": [[5.0, 20.0], [4.0, 24.0]],
        "ts_rel": [[-1, -1], [1, -1]], "sense_dis": 8.0}
    cfg["window"]["N"] = 8
    (root / "portbench" / "configs" / "demo9_tiny.json").write_text(json.dumps(cfg))
    tr = core.load_json("traffic", "tick1024.json")
    tr.update(robots=4, check_every=1, stat_checks=4)
    (root / "portbench" / "traffic" / "tick4.json").write_text(json.dumps(tr))
    (root / "portbench" / "metrics" / "extra.ticks_seen.py").write_text(
        "def read(run):\n    return float(len(run.records['ticks']))\n")
    m["configs"].append({"name": "demo9_tiny", "source": "x", "file": "portbench/configs/demo9_tiny.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "demo9_tiny.tick4", "config": "demo9_tiny", "traffic": "tick4",
                           "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "extra.ticks_seen", "unit": "ticks", "better": "higher",
                           "source": "program_counter", "layer": "rollout",
                           "moves": "replans_per_s", "workloads": ["demo9_tiny.tick4"]})
    for e in m["end_to_end"]:
        if e["name"] in ("replans_per_s", "tick_p95_ms"):
            e["workloads"].append("demo9_tiny.tick4")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    code = f"""
import sys, json
sys.path.insert(0, {str(root)!r}); sys.path.append({ROOT!r})
import torch
torch.set_num_threads(1)
from portbench.tests.cpu import cpu_run
from portbench.harness import core
m = core.load_manifest()
out, _ = cpu_run("demo9_tiny.tick4", seconds=0.5, manifest=m)
layer = [x["name"] for x in core.metrics_for(m, "demo9_tiny.tick4", 1)]
run_ticks = core.reader("extra.ticks_seen")
print(json.dumps({{"out": out, "layer": layer, "src": run_ticks.__file__}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=str(root))
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["out"]["correct"] is True, got["out"]["checks"]
    assert set(got["out"]["checks"]) >= {"viol_gap", "obj_gap", "feas_viol", "feas_stat"}
    assert set(got["out"]["metrics"]) == {"replans_per_s", "tick_p95_ms", "setup_s"}
    assert got["layer"] == ["extra.ticks_seen"]
    assert got["src"].startswith(str(root))


def test_result_line_keys_and_checks_last():
    from portbench.tests.cpu import cpu_run

    out, checks = cpu_run("demo9.tick1024", seconds=0.3, traffic={"robots": 4, "check_every": 1})
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["attempted"] == 4 * out["info"]["ticks"]
    assert {n for n, _, _ in checks} == set(out["checks"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_without_a_card_the_command_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "demo9.tick1024", "--seed", "3", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert p.returncode == 3 and p.stdout == ""


def test_without_the_port_the_command_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/."""
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "demo9.tick1024",
                        "--seed", "3", "--seconds", "1", "--trace", "0"], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout == ""


def test_import_guard_compares_top_level_names_whole():
    names = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1, "jaxtyping": 1,
             guard.JAX_PACKAGE + ".solver": 1, guard.PORT_PACKAGE + ".solver": 1, "numpy": 1}
    assert guard.forbidden_loaded(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax", guard.JAX_PACKAGE + ".solver"])
    with pytest.raises(guard.GuardError):
        guard.check("test", names)
    guard.check("test", {guard.PORT_PACKAGE: 1, "jaxtyping": 1})


def test_reference_imports_neither_the_port_nor_jax(tmp_path):
    assert guard.reference_sources_naming(os.path.join(BENCH, "reference")) == []
    (tmp_path / "bad.py").write_text(f"import numpy\nfrom {guard.PORT_PACKAGE}.ops import astar\n")
    assert guard.reference_sources_naming(str(tmp_path)) == ["bad.py:2"]
    code = f"""
import sys, json
sys.path.insert(0, {ROOT!r})
import portbench.reference.worlds, portbench.reference.astar, portbench.reference.obca
import portbench.reference.geometry, portbench.reference.rollout, portbench.reference.checks
import portbench.reference.kkt
from portbench.harness import guard
print(json.dumps(sorted(n for n in sys.modules if guard.top_level(n) in
                        (guard.PORT_PACKAGE,) + guard.FORBIDDEN)))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout) == []
