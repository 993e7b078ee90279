"""Import hygiene and device policy of the PyTorch port (`repro_torch`).

The port imports torch and numpy only: never jax and nothing of the JAX
package `repro` (its tests are the only place both meet).  Its entry points
run on CUDA unless the caller passes device="cpu", and asking for CUDA where
there is none raises instead of dropping to the CPU.  Kernel wrappers pick
kernel or plain version from the tensors' device alone: no try/except
fallback and no environment knob.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / n for n in ("chip_smoke.py", "same_call_baseline.py",
                       "episode_in_turns.py", "grid_in_turns.py",
                       "flash_in_turns.py", "examples/torch_quickstart.py",
                       "examples/torch_nmp_aimm_demo.py",
                       "examples/torch_sharding_search.py",
                       "examples/torch_train_lm.py")]
OPS_FILES = sorted(PORT.rglob("ops.py"))


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def test_port_has_files_to_scan():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for want in ("nmp/engine.py", "nmp/stats.py", "core/agent.py",
                 "core/dqn.py", "kernels/epoch_fused/ops.py",
                 "kernels/dueling_qnet/ops.py",
                 "kernels/flash_attention/ops.py",
                 "kernels/flash_attention/ref.py",
                 "kernels/ssd_scan/ops.py", "kernels/ssd_scan/ref.py",
                 "configs/base.py", "configs/minitron_8b.py",
                 "configs/mamba2_370m.py", "models/layers.py",
                 "models/attention.py", "models/mamba.py",
                 "models/transformer.py", "models/model.py",
                 "models/convert.py", "train/serve_step.py",
                 "launch/serve.py", "core/prng.py",
                 "kernels/threefry/ops.py", "kernels/threefry/ref.py",
                 "kernels/batched_linear/ops.py",
                 "kernels/batched_linear/ref.py",
                 "kernels/td_grad/ops.py", "kernels/td_grad/ref.py",
                 "kernels/adamw_lanes/ops.py", "kernels/adamw_lanes/ref.py",
                 "nmp/scenarios.py", "nmp/plan.py", "nmp/partition.py",
                 "nmp/sweep.py", "configs/aimm_nmp.py",
                 "nmp/continual.py", "nmp/serving.py", "nmp/faults.py",
                 "train/checkpoint.py", "core/tree.py", "models/moe.py",
                 "configs/gemma3_12b.py", "configs/deepseek_moe_16b.py",
                 "configs/qwen3_32b.py", "configs/phi3_medium_14b.py",
                 "configs/mixtral_8x22b.py",
                 "configs/jamba_1_5_large_398b.py", "testing.py",
                 "configs/whisper_large_v3.py",
                 "configs/llama_3_2_vision_11b.py", "train/data.py",
                 "train/elastic.py", "train/compression.py",
                 "train/optimizer.py", "train/train_step.py",
                 "train/loop.py", "launch/train.py",
                 "launch/memory_model.py", "launch/roofline.py",
                 "core/sharding_mapper.py", "sharding/policies.py",
                 "sharding/context.py", "launch/mesh.py",
                 "launch/dryrun.py", "kernels/costs.py"):
        assert want in names
    assert (ROOT / "chip_smoke.py").exists()
    assert {p.name for p in (PORT / "csrc").glob("*.cu")} == {
        "epoch_fused.cu", "dueling_qnet.cu", "flash_attention.cu",
        "ssd_scan.cu", "threefry.cu", "batched_linear.cu",
        "flash_attention_bwd.cu", "ssd_scan_bwd.cu", "td_grad.cu",
        "adamw_lanes.cu"}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


@pytest.mark.parametrize("path", sorted((PORT / "kernels").rglob("*.py")),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_kernels_import_no_module_that_imports_them(path):
    """A kernel module may use a helper of the layers above it, but never
    one that imports that kernel's package back: no import cycle, so each
    kernel package loads on its own."""
    package = ".".join(path.relative_to(PORT.parent).parts[:3])
    for mod in _imported_modules(path):
        if mod.split(".")[0] != "repro_torch" or mod.startswith(
                "repro_torch.kernels"):
            continue
        dep = PORT.parent / (mod.replace(".", "/") + ".py")
        back = [m for m in _imported_modules(dep) if m.startswith(package)]
        assert not back, (path, mod, back)


@pytest.mark.parametrize("path", OPS_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_kernel_wrappers_have_no_fallback(path):
    tree = ast.parse(path.read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path
    assert "environ" not in path.read_text(), path


def test_entry_points_default_to_cuda():
    from repro_torch.core.agent import cold_start
    from repro_torch.nmp.engine import default_agent_cfg, run_episode
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.traces import make_trace
    tr = make_trace("KM", n_ops=128)
    if torch.cuda.is_available():
        res = run_episode(tr)
        assert res.env.cycles.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            run_episode(tr)
        with pytest.raises(RuntimeError, match="cuda"):
            cold_start(0, default_agent_cfg(NMPConfig()))


def test_model_zoo_entry_points_default_to_cuda():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main
    from repro_torch.models import build_model
    if torch.cuda.is_available():
        m = build_model(get_config("mamba2-370m", smoke=True))
        assert m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(get_config("mamba2-370m", smoke=True))
        for arch in ("mamba2-370m", "whisper-large-v3"):
            with pytest.raises(RuntimeError, match="cuda"):
                main(["--arch", arch, "--smoke"])


def test_training_entry_points_default_to_cuda():
    from repro_torch.launch.train import main
    from repro_torch.train.data import DataConfig, SyntheticDataset
    if torch.cuda.is_available():
        ds = SyntheticDataset(DataConfig(vocab=16, seq=4, global_batch=2))
        assert next(ds)["tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            SyntheticDataset(DataConfig(vocab=16, seq=4, global_batch=2))
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--arch", "mamba2-370m", "--smoke", "--steps", "1"])


def test_zoo_backward_on_cpu_is_plain_autograd_and_counts_nothing():
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    fops.reset_launches()
    sops.reset_launches()
    q = torch.randn((1, 64, 4, 16), requires_grad=True)
    fops.gqa_flash_attention(q, q[:, :, :2], q[:, :, :2]).sum().backward()
    xs = [torch.randn((1, 64, 2, 8)), torch.randn((1, 64, 4)),
          torch.randn((1, 64, 4)), torch.rand((1, 64, 2)) * 0.1,
          -torch.rand(2) - 0.1]
    xs = [t.requires_grad_() for t in xs]
    sops.ssd(*xs, chunk=32).sum().backward()
    assert q.grad is not None and all(t.grad is not None for t in xs)
    assert fops.launches == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert sops.launches == {"ssd_scan": 0, "ssd_scan_bwd": 0}


def test_zoo_wrappers_on_cpu_take_the_plain_version_and_count_nothing():
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    fops.reset_launches()
    sops.reset_launches()
    q = torch.randn((1, 64, 4, 16))
    assert fops.gqa_flash_attention(q, q[:, :, :2], q[:, :, :2]).shape == \
        q.shape
    y = sops.ssd(torch.randn((1, 64, 2, 8)), torch.randn((1, 64, 4)),
                 torch.randn((1, 64, 4)), torch.rand((1, 64, 2)) * 0.1,
                 -torch.rand(2) - 0.1, chunk=32)
    assert y.shape == (1, 64, 2, 8) and torch.isfinite(y).all()
    assert fops.launches == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert sops.launches == {"ssd_scan": 0, "ssd_scan_bwd": 0}


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    from repro_torch.kernels.dueling_qnet import ops as qops
    from repro_torch.kernels.epoch_fused import ops as eops
    from repro_torch.nmp.config import NMPConfig
    from repro_torch.nmp.engine import run_episode
    from repro_torch.nmp.traces import make_trace
    qops.reset_launches()
    eops.reset_launches()
    res = run_episode(make_trace("KM", n_ops=256), NMPConfig(), "pei", "tom",
                      device="cpu")
    assert res.env.cycles.device.type == "cpu"
    assert np.isfinite(float(res.env.cycles))
    assert eops.launches == {"fused_epoch": 0, "tom_scores": 0,
                             "tom_scores_folded": 0}
    assert qops.launches == {"dueling_qnet": 0}
