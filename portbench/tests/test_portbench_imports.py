"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names, and the reference loads nothing of the program."""

import subprocess
import sys
from pathlib import Path

from portbench.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print('\\n'.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "coda_neurips2023_tpu_torch_x", object())
    assert "coda_neurips2023_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "coda_neurips2023_tpu.engine", object())
    assert "coda_neurips2023_tpu" in forbidden_modules()


def test_harness_and_program_load_no_jax():
    mods = _modules("import portbench.run as r, portbench.check, portbench.trace, "
                    "portbench.readers\nr.program()")
    assert "coda_neurips2023_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = _modules("import portbench.reference.build, portbench.scenes, portbench.weights, "
                    "portbench.flops")
    assert not mods & (set(FORBIDDEN) | {"coda_neurips2023_tpu_torch"})


def test_no_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/ the command
    fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "baseline-sunrgbd.train", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
