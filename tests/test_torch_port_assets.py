"""The port's data files are its own.

The port ships the files it reads (CLIP's BPE merge table and the class-name
lists) in coda_neurips2023_tpu_torch/datasets/assets/, byte for byte the JAX
package's.  These tests hold that: the copies are identical, a copy of the
port alone (no JAX package on the path) builds the tokenizer and the
46-class eval config with the real names, and no module of the port names
the JAX package's directory in a path.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from coda_neurips2023_tpu.datasets import config as jax_config
from coda_neurips2023_tpu.models.tokenizer import SimpleTokenizer as JaxTokenizer

from coda_neurips2023_tpu_torch.datasets import config as port_config
from coda_neurips2023_tpu_torch.models import tokenizer as port_tokenizer
from torch_one_thread import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "coda_neurips2023_tpu_torch"
PORT_ASSETS = PORT / "datasets" / "assets"
JAX_ASSETS = Path(jax_config.DEFAULT_ASSET_DIR)
FILES = ("bpe_simple_vocab_16e6.txt.gz", "all_classes_trainval_v1.npy", "ov_3detr.npy",
         "ov_3detr_scannet.npy", "lvis_1204.npy", "scannet_200_classname_no_wall_floor.npy",
         "scannet_200_class2id.npy")
PROMPT = "a photo of a night stand, and a sofa_chair!"


def test_the_port_reads_its_own_assets():
    assert Path(port_config.DEFAULT_ASSET_DIR) == PORT_ASSETS
    assert Path(port_tokenizer.PACKAGED_BPE_PATH) == PORT_ASSETS / FILES[0]


@pytest.mark.parametrize("name", FILES)
def test_asset_is_byte_identical_to_the_jax_packages(name):
    assert (PORT_ASSETS / name).read_bytes() == (JAX_ASSETS / name).read_bytes()


def test_assets_are_exactly_the_listed_files():
    assert sorted(p.name for p in PORT_ASSETS.iterdir()) == sorted(FILES)


def test_port_copy_alone_builds_tokenizer_and_eval_config(tmp_path):
    """A copy of the port, with nothing else of the repo on the path, finds
    its BPE table and its class names (not the class_0000... fallback)."""
    shutil.copytree(PORT, tmp_path / PORT.name, ignore=shutil.ignore_patterns("__pycache__"))
    script = (
        "import importlib.util, json\n"
        "assert importlib.util.find_spec('coda_neurips2023_tpu') is None\n"
        "from coda_neurips2023_tpu_torch.models.tokenizer import SimpleTokenizer\n"
        "from coda_neurips2023_tpu_torch.datasets.config import SunrgbdImageConfig\n"
        "cfg = SunrgbdImageConfig()\n"
        f"print(json.dumps({{'tokens': SimpleTokenizer().encode({PROMPT!r}),"
        " 'names': cfg.vocab_names, 'semcls': cfg.num_semcls}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CODA_CLIP_BPE")}
    env["PYTHONPATH"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["tokens"] == JaxTokenizer().encode(PROMPT)
    want = jax_config.SunrgbdImageConfig()
    assert got["semcls"] == 46 and len(got["names"]) == 46
    assert got["names"] == [want.class2type[i] for i in range(46)]
    assert not any(name.startswith("class_") for name in got["names"])


def _docstrings(tree):
    nodes = [tree] + [n for n in ast.walk(tree)
                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    return {id(n.body[0].value) for n in nodes
            if n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}


def test_no_port_module_names_the_jax_package_in_a_path():
    """String constants (docstrings aside) never hold `coda_neurips2023_tpu`
    as a path component: the port opens nothing under the JAX package."""
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        skip = _docstrings(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in skip
                    and "coda_neurips2023_tpu" in node.value.replace("\\", "/").split("/")):
                offenders.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert offenders == []
