"""A later change adds a configuration, a traffic mix and a per-layer metric
as new files (and their entries in ``BENCHMARK.json``); the harness lists
and runs them with no other edit. Shown in a copy of the tree."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_alone_add_a_cell(tmp_path, tiny_scale):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench_dir = tmp_path / "benchmark"
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

    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    listing = subprocess.run([sys.executable, "benchmark/run.py", "--list"], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=120)
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
    run = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["batches.bulk"]["value"] >= 1
