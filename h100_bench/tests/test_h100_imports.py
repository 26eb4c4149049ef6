"""Nothing the benchmark runs imports JAX or the JAX package: top-level
module names compared whole (`gan_codes_tpu_torch` is the port)."""
import ast
import os
import subprocess
import sys

from h100_bench import core, spec as spec_mod

ROOT = os.path.dirname(spec_mod.BENCH_DIR)


def test_sources_import_neither():
    for dirpath, _, files in os.walk(spec_mod.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and not node.level:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in core.FORBIDDEN, (f, n)


def test_a_run_loads_neither():
    code = (
        "import sys, json, torch; torch.set_num_threads(2)\n"
        "sys.path.insert(0, 'h100_bench/tests')\n"
        "from conftest import TINY\n"
        "from h100_bench import core\n"
        "r = core.run_cell('cub256-tf32-gen', 3, 0.5, False, device='cpu',"
        " size=TINY)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "gan_codes_tpu_torch" in loaded
    assert not loaded & set(core.FORBIDDEN)


def test_the_harness_refuses_a_process_holding_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    assert core.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "gan_codes_tpu_torch.x", object())
    assert "gan_codes_tpu" not in core.forbidden_modules()


def test_no_result_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and h100_bench/, a run
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec_mod.BENCH_DIR, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "cub256-tf32-gen", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, text=True, capture_output=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
