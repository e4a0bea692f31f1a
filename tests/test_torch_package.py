"""Package rules of cmda_tpu_torch: it imports neither JAX nor the JAX
package nor the JAX package's tools (checked by a clean subprocess and by an
AST scan of every module, for the package and for chip_smoke.py), its entry points default to the GPU, and its
configs mirror the JAX package's field for field."""
import ast
import dataclasses
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import cmda_tpu_torch
from cmda_tpu import config as JC
from cmda_tpu_torch import apis as tapis
from cmda_tpu_torch import config as TC

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "cmda_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cmda_tpu", "tools")


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in FORBIDDEN


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        cmda_tpu_torch.__path__, "cmda_tpu_torch."))


def test_import_loads_no_jax_and_no_cmda_tpu():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"cmda_tpu_torch.apis", "cmda_tpu_torch.data.dsec",
            "cmda_tpu_torch.data.cityscapes_ic", "cmda_tpu_torch.data.h5",
            "cmda_tpu_torch.data.source_augs",
            "cmda_tpu_torch.tools.make_fake_corpus",
            "cmda_tpu_torch.data.unpaired", "cmda_tpu_torch.utils.misc",
            "cmda_tpu_torch.uda.cyclegan_train",
            "cmda_tpu_torch.uda.org_dacs", "cmda_tpu_torch.uda.dacs_image",
            "cmda_tpu_torch.uda.prototype",
            "cmda_tpu_torch.tools.train_cyclegan",
            "cmda_tpu_torch.tools.create_cityscapes_image_change",
            "cmda_tpu_torch.models.heads", "cmda_tpu_torch.models.resnet",
            "cmda_tpu_torch.tools.run_experiments",
            "cmda_tpu_torch.utils.profiling",
            "cmda_tpu_torch.tools.export_model",
            "cmda_tpu_torch.tools.bench_infer",
            "cmda_tpu_torch.tools.bench_ce",
            "cmda_tpu_torch.tools.bench_scan",
            "cmda_tpu_torch.tools.profile_step",
            "cmda_tpu_torch.tools.analyze_trace",
            "cmda_tpu_torch.tools.train_chunked",
            "cmda_tpu_torch.tools.merge_segment_logs",
            "cmda_tpu_torch.tools.checkpoint_tools",
            "cmda_tpu_torch.tools.print_config",
            "cmda_tpu_torch.tools.analyze_logs"} <= set(
                loaded)
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_default_device_needs_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapis.init_segmentor("micro")


@pytest.mark.parametrize("entry", ["cyclegan", "org_dacs", "dacs_image",
                                   "train_cyclegan", "en"])
def test_image_trainers_default_to_cuda(entry, monkeypatch, tmp_path):
    """The CycleGAN trainer and its CLI, OrgDACS, DACSImage and the EN tool
    run on cuda unless asked for the CPU, and raise without a GPU."""
    import torch
    from cmda_tpu_torch.tools import create_cityscapes_image_change as ic
    from cmda_tpu_torch.tools import train_cyclegan
    from cmda_tpu_torch.uda.cyclegan_train import (CycleGANConfig,
                                                   CycleGANTrainer)
    from cmda_tpu_torch.uda.dacs_image import DACSImageTrainer
    from cmda_tpu_torch.uda.org_dacs import OrgDACSTrainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "0.png").write_bytes(b"")
    calls = {
        "cyclegan": lambda: CycleGANTrainer(CycleGANConfig()),
        "org_dacs": lambda: OrgDACSTrainer(TC.micro_test_config()),
        "dacs_image": lambda: DACSImageTrainer(TC.micro_test_config()),
        "train_cyclegan": lambda: train_cyclegan.main([
            "--data-a", str(tmp_path / "a"), "--data-b",
            str(tmp_path / "b"), "--work-dir", str(tmp_path / "w")]),
        "en": lambda: ic.load_generator(str(tmp_path / "g.pth"))}
    if entry == "en":
        from cmda_tpu_torch.models.cyclegan import ResnetGenerator
        torch.save(ResnetGenerator(ngf=8, n_blocks=1).state_dict(),
                   tmp_path / "g.pth")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def _fields(obj):
    """Field names and default values of a config tree, recursively."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [_fields(x) for x in obj]
    return obj


@pytest.mark.parametrize("preset", ["cs2dsec_image_events_b5",
                                    "cs2dz_image_rawisr_b5",
                                    "tiny_test_config", "micro_test_config"])
def test_config_presets_mirror_jax(preset):
    assert _fields(getattr(TC, preset)()) == _fields(getattr(JC, preset)())
