"""Import hygiene and device policy of the PyTorch port.

* ``src/repro_torch/**`` (its zenlint ``analysis/`` included), the port's
  examples ``examples/torch_*.py`` and ``chip_smoke.py`` import neither JAX
  nor the reference package ``repro`` (an ``ast`` walk);
* entry points run on CUDA unless ``device="cpu"`` is passed, and raise
  without a GPU instead of falling back to the CPU;
* every CUDA source names the TPU kernel it replaces.
"""
import ast
import dataclasses
import types
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.kernels import _build, ops
from repro_torch.launch import train
from repro_torch.models.attention import MLA
from repro_torch.models.model import Model
from repro_torch.train.build import build_program, parse_mesh

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         sorted((ROOT / "examples").glob("torch_*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_hygiene_walk_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom jax import numpy\nfrom repro.core import x\n"
                 "import repro_torch\n")
    assert [m for m in _imports(f) if _forbidden(m)] == ["jax", "repro.core"]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_never_fall_back(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_program(cfg, "1x1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps", "1"])
    assert build_program(cfg, "2x1", device="cpu").device.type == "cpu"


def test_unported_meshes_and_flags_raise():
    """What tensor parallelism (M > 1) does not run raises naming its
    ROADMAP item: M > 1 without ``--dist`` (the model axis is one process
    a rank), beside pods or ``--node-size > 1`` too, which build with a
    model group (tests/test_torch_mesh3.py runs them); every
    kind builds at 1x2 (the ssm, hybrid, MLA, enc_dec and vlm kinds here,
    with a stand-in model group: a build runs no collective; all of them
    run in tests/test_torch_tp*.py), as do pod meshes and ``--node-size``
    (tests/test_torch_hier.py); minicpm3-4b, the last config the port
    lacked, builds with the reference's fields (read from its source, so
    that this module imports no JAX) and an unknown arch raises."""
    assert parse_mesh("2x2") == (1, 2, 2)
    assert parse_mesh("2x4x2") == (2, 4, 2)
    assert parse_mesh("8x1") == (1, 8, 1)
    assert parse_mesh("2x4x1") == (2, 4, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.*torchrun|"
                       "torchrun.*ROADMAP"):
        train.main(["--arch", "qwen2-0.5b", "--reduced", "--mesh", "2x2",
                    "--device", "cpu"])
    for arch in ("mamba2-370m", "zamba2-1.2b", "minicpm3-4b",
                 "whisper-medium", "pixtral-12b"):
        cfg = get_config(arch).reduced()
        for rank in (0, 1):
            model = build_program(cfg, "1x2", device="cpu", model_group=(
                types.SimpleNamespace(ranks=(rank,), n=2, pg=None))).model
            whole = dict(Model(cfg, device="cpu").named_leaves())
            for name, dim in model.shard_dims().items():
                want = whole[name] if dim is None else whole[name].chunk(
                    2, dim)[rank]
                assert torch.equal(dict(model.named_leaves())[name], want), \
                    (arch, name)
    qwen = get_config("qwen2-0.5b").reduced()
    for mesh, node_size in (("2x2x2", 1), ("4x2", 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1, "
                           "item 9"):
            build_program(qwen, mesh, device="cpu", node_size=node_size)
        prog = build_program(qwen, mesh, device="cpu", node_size=node_size,
                             model_group=types.SimpleNamespace(
                                 ranks=(0,), n=2, pg=None))
        assert (prog.pods * prog.n_data, prog.node_size) == (4, node_size)
    ref = ast.parse((ROOT / "src" / "repro" / "configs" /
                     "minicpm3_4b.py").read_text())
    call = next(n for n in ast.walk(ref) if isinstance(n, ast.Call)
                and getattr(n.func, "id", "") == "ArchConfig")
    cfg = get_config("minicpm3-4b")
    assert len(call.keywords) == 14
    for kw in call.keywords:
        assert getattr(cfg, kw.arg) == ast.literal_eval(kw.value), kw.arg
    with pytest.raises(KeyError, match="minicpm3-4b"):
        get_config("minicpm3")


def test_mamba2_trainer_raise_names_the_plain_scan_trainer():
    """The Mamba2 trainer is the plain-scan trainer the reference runs: a
    train loss raises nothing, its backward is the plain chunked scan's
    gradient (one recompute a layer, never a gradient through the SSD
    kernel; the layer's own recompute runs the scan's forward a second
    time); a dense config with ``mla_kv_rank`` set builds MLA, never
    GQA."""
    cfg = get_config("mamba2-370m").reduced()
    model = Model(cfg, device="cpu")
    tok = torch.zeros((1, 16), dtype=torch.long)
    ops.reset_counts()
    model(tok, tok).backward()
    assert ops.PLAIN_CALLS["ssd_fwd"] == 2 * cfg.n_layers
    assert ops.RECOMPUTE_CALLS["ssd_fwd"] == cfg.n_layers
    assert model.embed.table.grad is not None
    mla = Model(dataclasses.replace(cfg, kind="dense", mla_q_rank=64,
                                    mla_kv_rank=32), device="cpu")
    assert all(isinstance(ly.attn, MLA) for ly in mla.layers)


def test_cuda_sources_name_the_kernel_they_replace():
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replace" in src and "repro/kernels/" in src, name
        assert "repro_torch/kernels/ref.py" in src, name
    # builds land in the git-ignored build/ directory
    assert _build.build_dir().relative_to(ROOT).parts[0] == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
