"""A later change adds a configuration, a traffic mix, a per-layer metric or
an encoder architecture as new files (and their entries in
``BENCHMARK.json``); the harness lists and runs them with no other edit.
Shown in a copy of the tree."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def copy_tree(tmp_path: Path) -> Path:
    """``BENCHMARK.json`` and the harness without its tests, in ``tmp_path``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path / "benchmark"


def in_copy(tmp_path: Path, args: list[str], timeout: int):
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    return subprocess.run([sys.executable, *args], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_new_files_alone_add_a_cell(tmp_path, tiny_scale):
    bench_dir = copy_tree(tmp_path)
    cfg = json.loads((bench_dir / "configs" / "minilm-l6-cap1m.json").read_text())
    cfg["name"] = "minilm-l12-cap1m"
    cfg["encoder"].update(family="minilm-l12", num_hidden_layers=12)
    (bench_dir / "configs" / "minilm-l12-cap1m.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "bulk-256.json").read_text())
    mix["batch"] = 64
    (bench_dir / "traffic" / "bulk-64.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "batches.bulk.py").write_text(textwrap.dedent('''\
        """batches.bulk: batches the window ran."""


        def read(obs):
            return len(obs["window_batches"]) or None
        '''))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "minilm-l12-cap1m", "source": "https://huggingface.co/x/y",
                             "file": "benchmark/configs/minilm-l12-cap1m.json", "reduced": ["cases"],
                             "why": "a test"})
    bench["workloads"].append({"name": "minilm-l12.bulk-64", "config": "minilm-l12-cap1m",
                               "traffic": "bulk-64", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "batches.bulk", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "engine and store", "moves": "qps",
                               "workloads": ["minilm-l12.bulk-64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    listing = in_copy(tmp_path, ["benchmark/run.py", "--list"], 120)
    assert listing.returncode == 0, listing.stderr
    new = [ln for ln in listing.stdout.splitlines() if ln.startswith("minilm-l12.bulk-64:")]
    assert new and "bulk-64.json" in new[0] and "batches.bulk" in new[0]

    scale = dict(tiny_scale, traffic=dict(tiny_scale["traffic"], batch=16))
    script = textwrap.dedent(f'''
        import json, time
        from pathlib import Path
        from benchmark import cell
        assert cell.ROOT.resolve() == Path({str(tmp_path)!r}).resolve(), cell.ROOT
        spec = cell.load_spec("minilm-l12.bulk-64")
        spec.config["serving"]["store_workers"] = 2
        out = cell.run(spec, 99, 1.0, True, "cpu", time.perf_counter(), scale={scale!r})
        print(json.dumps(out["line"]))
        ''')
    run = in_copy(tmp_path, ["-c", script], 600)
    assert run.returncode == 0, run.stderr[-3000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["batches.bulk"]["value"] >= 1


def test_new_files_alone_add_an_encoder_architecture(tmp_path, tiny_scale):
    """A toy pre-norm, causal, last-token encoder enters as its plug-in,
    its reference, its configuration (and a module standing in for the
    port's, ``toy_port/``), copied in from ``toy_arch/`` with no other edit;
    a tiny cell of it is ``correct``, its float8 control is not, and a run
    whose encoder leaves out each layer's FFN is not ``correct``."""
    copy_tree(tmp_path)
    shutil.copytree(Path(__file__).parent / "toy_arch", tmp_path, dirs_exist_ok=True)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-prenorm-tiny", "source": "https://huggingface.co/x/y",
                             "file": "benchmark/configs/toy-prenorm-tiny.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-prenorm.bulk-256", "config": "toy-prenorm-tiny",
                               "traffic": "bulk-256", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    listing = in_copy(tmp_path, ["benchmark/run.py", "--list"], 120)
    assert listing.returncode == 0, listing.stderr
    new = [ln for ln in listing.stdout.splitlines() if ln.startswith("toy-prenorm.bulk-256:")]
    assert new and "arch=toy-prenorm encoder=benchmark/encoders/toy-prenorm.py" in new[0]

    scale = dict(tiny_scale, traffic=dict(tiny_scale["traffic"], batch=16))
    script = textwrap.dedent(f'''
        import json, time
        from benchmark import cell
        from toy_port import prenorm

        spec = cell.load_spec("toy-prenorm.bulk-256")
        spec.config["serving"]["store_workers"] = 2
        sound = cell.run(spec, 2**31 + 77, 1.0, False, "cpu", time.perf_counter(), scale={scale!r}, control=True)

        linear = prenorm.PrenormEncoder.linear

        def ffn_left_out(self, x, i, name):
            out = linear(self, x, i, name)
            return out * 0 if name == "wo" else out

        prenorm.PrenormEncoder.linear = ffn_left_out
        broken = cell.run(spec, 2**31 + 77, 1.0, False, "cpu", time.perf_counter(), scale={scale!r})
        print(json.dumps({{"sound": sound["line"], "control": sound["control"], "broken": broken["line"]}}))
        ''')
    run = in_copy(tmp_path, ["-c", script], 900)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    limit = out["sound"]["checks"]["score_gap"]["limit"]
    assert out["sound"]["correct"], out["sound"]["checks"]
    assert out["control"]["score_gap"] > limit, out["control"]
    assert not out["broken"]["correct"], out["broken"]["checks"]
