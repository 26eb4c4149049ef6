"""A configuration, a cell and a per-layer metric added as files of their
own, with entries in BENCHMARK.json, and no existing file edited: the
harness finds and runs them."""
import json
import os
import shutil

from h100_bench import core, spec as spec_mod

READER = '''"""Calls in the window (a throwaway metric)."""


def read(run):
    return float(run.program["calls"]) if run.program.get("calls") else None
'''


def test_new_files_make_a_new_cell(tmp_path, tiny):
    root = tmp_path
    bench = root / "h100_bench"
    shutil.copytree(spec_mod.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    def files():
        return {os.path.join(dp, f): open(os.path.join(dp, f), "rb").read()
                for dp, _, fs in os.walk(bench) for f in fs
                if not f.endswith(".pyc")}

    before = files()
    manifest = json.load(open(os.path.join(os.path.dirname(
        spec_mod.BENCH_DIR), "BENCHMARK.json")))
    # a configuration: the fp32 one at tiny sizes, in a file of its own
    cfg = core.merge(json.load(open(bench / "configs" /
                                    "dfgan-cub256-fp32.json")), tiny["cfg"])
    cfg["name"] = "dfgan-tiny"
    (bench / "configs" / "dfgan-tiny.json").write_text(json.dumps(cfg))
    # a traffic mix for an existing driver
    (bench / "traffic" / "captions-b8.json").write_text(json.dumps(
        {"driver": "generate", "batch": 8,
         "caption_words": {"mean": 9, "sd": 2, "min": 3, "max": 18}}))
    (bench / "workloads" / "tiny-gen.json").write_text(json.dumps(
        {"limits": {"img_max_abs": 0.1, "img_rms": 0.01},
         "sample_calls": 2, "trace_calls": 2}))
    (bench / "metrics" / "calls.tiny.py").write_text(READER)
    manifest["configs"].append(
        {"name": "dfgan-tiny", "source": "test", "reduced": [],
         "file": "h100_bench/configs/dfgan-tiny.json", "why": "test"})
    manifest["workloads"].append(
        {"name": "tiny-gen", "config": "dfgan-tiny",
         "traffic": "captions-b8", "chips": 1, "why": "test"})
    manifest["end_to_end"][1]["workloads"].append("tiny-gen")
    manifest["per_layer"].append(
        {"name": "calls.tiny", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "sampler",
         "moves": "gen_img_per_s", "workloads": ["tiny-gen"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    spec = spec_mod.Spec(root=str(root), bench_dir=str(bench))
    assert {m["name"] for m in spec.per_layer("tiny-gen")} == {"calls.tiny"}
    r = core.run_cell("tiny-gen", 5, 0.5, True, device="cpu", spec=spec)
    assert r["correct"], r["checks"]
    assert r["metrics"]["calls.tiny"]["value"] == r["attempted"]
    r = core.run_cell("tiny-gen", 5, 0.5, False, device="cpu", spec=spec)
    assert set(r["metrics"]) == {"gen_img_per_s", "setup_s"}
    after = files()
    assert all(after[p] == before[p] for p in before)
