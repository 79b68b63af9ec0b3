"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level names (legkilo_torch begins with legkilo_t, but is not
legkilo_tpu)."""

import os
import subprocess
import sys

from portbench import harness


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("legkilo_torch", "legkilo_torch.core", "jaxtyping", "flax_like", "legkilo_tpux"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "legkilo_tpu", raising=False)
    assert not (set(harness.forbidden_modules()) & {"legkilo_tpux", "jaxtyping", "flax_like"})
    monkeypatch.setitem(sys.modules, "legkilo_tpu.core.filter", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert {"legkilo_tpu", "jaxlib"} <= set(harness.forbidden_modules())


def test_a_run_loads_no_jax(root):
    """A fresh process that imports everything a run imports (the harness,
    the readers, the reference, the port) loads no module of JAX or of the
    JAX package."""
    code = (
        "import sys, importlib, json\n"
        f"sys.path.insert(0, {root!r})\n"
        "from portbench import harness, manifest, control, trace\n"
        "from portbench.reference import filter\n"
        "import legkilo_torch.parallel.sweep, legkilo_torch.runner\n"
        "man = manifest.Manifest(sys.path[0])\n"
        "for m in man.doc['end_to_end'] + man.doc['per_layer']: man.reader(m['name'])\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_file_reads_the_jax_package(root):
    """No source of the benchmark names the JAX package or bench.py as
    something to import or open."""
    bad = []
    for dirpath, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            text = open(os.path.join(dirpath, f)).read()
            for needle in ("import legkilo_tpu", "from legkilo_tpu", "import jax", "from jax",
                           "bench.py\")", "'bench.py'"):
                if needle in text and f != "test_portbench_imports.py":
                    bad.append((f, needle))
    assert bad == []


def test_reference_imports_nothing_of_the_port(root):
    """The reference's sources import nothing of the port, of JAX or of
    the JAX package, and nothing of the benchmark but the reference."""
    import ast

    ref = os.path.join(root, "portbench", "reference")
    for f in sorted(os.listdir(ref)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("numpy", "torch", "math", "typing", "__future__"), (f, n)


def test_without_the_port_a_run_fails_and_prints_nothing(root, tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits non-zero with nothing on standard output."""
    import shutil

    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "go1_imu.mc256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""
