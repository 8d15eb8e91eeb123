"""The port imports no JAX, and chip_smoke.py refuses to run without a card.

The machine with the card has no JAX, so neither the port package nor
``chip_smoke.py`` may import it, directly or through the JAX package
(whose ``data/__init__`` pulls in jax via ``pipeline.py``, and whose
``utils/config.py::build_parser`` imports ``ops/quantize.py``).
"""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import dasemanticsegmentationaml_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(port.__file__)
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|"
    r"dasemanticsegmentationaml_tpu)\b", re.M)


def _run(code, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="dasemanticsegmentationaml_tpu_torch."))
    assert {f"dasemanticsegmentationaml_tpu_torch.{m}" for m in (
        "cli", "data.augment", "data.augment_pil_exact",
        "data.host_augment", "data.native_augment", "ops.losses",
        "ops.schedules", "ops.cuda.fused_ce",
        "ops.cuda.fused_stdc", "ops.cuda.copy_probe", "ops.cuda.tile_roll",
        "ops.norm", "models.discriminator", "tools", "tools.probe_copy",
        "tools.roll_repro", "train.adversarial", "train.optim",
        "train.supervised", "utils.checkpoint", "utils.logging_util",
        "utils.tb_writer", "utils.state_io", "utils.label_tools",
        "data.native", "data.cache", "data.transforms_host",
        "ops.quantize", "ops.cuda.int8_conv", "train.evaluate",
        "utils.export", "serve", "hpo", "hpo.search", "hpo.trial",
        "hpo.experiment")
    } <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from dasemanticsegmentationaml_tpu_torch.cli import main\n"
        "from dasemanticsegmentationaml_tpu_torch.utils.config import parse_args\n"
        "parse_args(['--domain_shift', 'True'])\n"
        "from dasemanticsegmentationaml_tpu_torch.train.supervised import train\n"
        "from dasemanticsegmentationaml_tpu_torch.train.adversarial import train_da\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "        'dasemanticsegmentationaml_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_port_sources_name_no_jax_import():
    offenders = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            if FORBIDDEN.search(f.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert not offenders


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA here: exit non-zero and print no result line, both from the
    checkout and from a directory holding chip_smoke.py alone."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd in (REPO, str(alone)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, PYTHONPATH=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_port_serving_process_imports_no_model_code(tmp_path):
    """The serving host's claim (utils/export.py): a process that imports
    ``serve`` and loads an artifact, on the CPU here, imports nothing of
    ``models/`` (nor of JAX)."""
    from dasemanticsegmentationaml_tpu_torch.models import BiSeNet
    from dasemanticsegmentationaml_tpu_torch.utils.export import (
        export_inference)

    path = str(tmp_path / "m.pt2")
    export_inference(BiSeNet(19).eval(), 32, 64, batch=1, path=path)
    code = (
        "import sys, torch\n"
        "from dasemanticsegmentationaml_tpu_torch import serve\n"
        "from dasemanticsegmentationaml_tpu_torch.utils.export import "
        "load_exported\n"
        f"out = load_exported({path!r})(torch.zeros((1, 32, 64, 3), "
        "dtype=torch.uint8))\n"
        "assert out.shape == (1, 32, 64), out.shape\n"
        "bad = [m for m in sys.modules if m.startswith("
        "'dasemanticsegmentationaml_tpu_torch.models') or m.split('.')[0] "
        "in ('jax', 'dasemanticsegmentationaml_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout
