"""The port stands alone and runs on the card unless told otherwise.

* A static scan (the container may preload jax, so importing and then
  checking ``sys.modules`` proves nothing): no file of ``fsnet_tpu_torch``,
  not ``chip_smoke.py`` and not the tree writers it runs
  (``tests/disk_trees.py``) imports ``jax``, ``flax``, ``optax`` or
  ``fsnet_tpu``; none imports, at module level, a package the machine
  with the card lacks: ``cv2``, ``PIL``, ``open3d``, the pip ``easydict``
  or ``tensorboard`` (the training script imports its optional writer
  inside a function); and none imports ``cv2``, ``PIL`` or ``open3d``
  anywhere: the images are read by the port's own PNG and JPEG readers,
  the point clouds by its own PCD reader. PyYAML, which that machine has,
  reads the fisheye and FusionPortable calibration.
* In a fresh interpreter whose imports of those packages raise, every
  module of ``fsnet_tpu_torch`` imports.
* Entry points called without ``device=`` raise when no CUDA device is
  present, instead of quietly running on the CPU.
* ``chip_smoke.py`` fails, and prints no result, without a CUDA device.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "fsnet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "disk_trees.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "fsnet_tpu"}
HOST_ONLY = {"cv2", "PIL", "open3d", "easydict", "tensorboard"}
DECODERS = {"cv2", "PIL", "open3d"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_decoder_import(path):
    bad = DECODERS.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _module_level_imports(path: Path):
    """Module names imported by the statements of the module body (also
    inside a top-level ``if`` or ``try``), not inside functions."""
    def walk(stmts):
        for node in stmts:
            if isinstance(node, ast.Import):
                yield from (alias.name for alias in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                yield node.module
            elif isinstance(node, (ast.If, ast.Try)):
                for block in ("body", "orelse", "finalbody"):
                    yield from walk(getattr(node, block, []))
                for handler in getattr(node, "handlers", []):
                    yield from walk(handler.body)
    yield from walk(ast.parse(path.read_text(), str(path)).body)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_host_only_import_at_module_level(path):
    bad = sorted(name for name in _module_level_imports(path)
                 if name.split(".")[0] in HOST_ONLY
                 or "tensorboard" in name.split("."))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_jax():
    """Each module of the port, the fisheye, FusionPortable, evaluation
    and export modules among them, imported in one fresh interpreter
    that refuses ``jax``, ``fsnet_tpu``, ``cv2``, ``PIL`` and
    ``open3d``."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "fsnet_tpu_torch").rglob("*.py"))
    for name in ("fsnet_tpu_torch.data.datasets.fisheye_dataset",
                 "fsnet_tpu_torch.data.datasets.fusionportable_dataset",
                 "fsnet_tpu_torch.evaluation.kitti360_fisheye_eval",
                 "fsnet_tpu_torch.evaluation.fusionportable_eval",
                 "fsnet_tpu_torch.evaluation.kitti_supervised_eval",
                 "fsnet_tpu_torch.runtime.export",
                 "fsnet_tpu_torch.configs.kitti360_fisheye_example"):
        assert name in modules, name
    code = (
        "import importlib, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in %r:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "for m in %r:\n"
        "    importlib.import_module(m)\n"
        % (sorted(FORBIDDEN | DECODERS), modules))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_model_without_device_raises():
    _no_cuda()
    from fsnet_tpu_torch.entry import flagship_model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship_model(64, 96)


def test_fisheye_model_without_device_raises():
    _no_cuda()
    from fsnet_tpu_torch.entry import fisheye_model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        fisheye_model(64, 128)


def test_dla_model_without_device_raises():
    _no_cuda()
    from fsnet_tpu_torch.entry import dla_model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        dla_model(64, 128)


@pytest.mark.parametrize("name", ["nusc_model", "distill_model"])
def test_nusc_models_without_device_raise(name):
    _no_cuda()
    from fsnet_tpu_torch import entry

    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(entry, name)(64, 128)


def test_eval_step_without_device_raises():
    _no_cuda()
    from fsnet_tpu_torch.runtime.state import make_eval_step

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_step()


def test_train_step_without_device_raises():
    _no_cuda()
    from fsnet_tpu_torch.runtime.state import make_train_step

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step()


def test_entry_without_device_raises():
    _no_cuda()
    from fsnet_tpu_torch.entry import entry

    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


@pytest.mark.parametrize("name", ["train", "test"])
def test_train_and_test_without_device_raise(name):
    _no_cuda()
    from fsnet_tpu_torch import entry

    config = str(ROOT / "fsnet_tpu_torch" / "configs" /
                 "synthetic_smoke_example.py")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(entry, name)(config)


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok")), line


def test_chip_smoke_fails_without_cuda():
    _no_cuda()
    _run_smoke(ROOT)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _run_smoke(tmp_path)
