"""The PyTorch port's checkpoints (`repro_torch/train/checkpoint.py`) against
the reference's `repro.train.checkpoint`, on the CPU.

The on-disk format is the reference's: for the same tree both packages
write the same `meta.json` (leaf keys in the same order, shapes, dtypes,
crc32 and extras, byte for byte), and each restores what the other wrote,
every leaf `==` with its dtype.  Then the port alone: the atomic commit
leaves no `.tmp` and removes a stale one, retention (`keep`), `wait()`
re-raising a failed async write, fallback past a corrupt newest step, a
tampered leaf caught by its crc32, the empty-directory errors and a bf16
leaf's round trip (read by the reference too).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent as j_agent
from repro.nmp import NMPConfig as JCfg
from repro.nmp.engine import default_agent_cfg as j_agent_cfg
from repro.train import checkpoint as j_ckpt
from repro_torch.core import agent as t_agent
from repro_torch.nmp import faults
from repro_torch.nmp.config import NMPConfig as TCfg
from repro_torch.nmp.engine import default_agent_cfg as t_agent_cfg
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train.checkpoint import (CheckpointCorruptError,
                                          CheckpointManager, leaf_paths)

J_ACFG = j_agent_cfg(JCfg())
T_ACFG = t_agent_cfg(TCfg())
EXTRAS = {"tags": ["a", "stream"], "meta": {"a": {"phases": 1}},
          "capacity": None, "evictions": 0, "rollbacks": 0}


@pytest.fixture(scope="module")
def ref_snapshots():
    """Two reference agents as host snapshots: one cold, one that acted
    (counters and key moved)."""
    a = j_agent.cold_start(3, J_ACFG)
    b = j_agent.cold_start(4, J_ACFG)
    _, b = j_agent.act(b, J_ACFG, jnp.ones(J_ACFG.dqn.state_dim))
    return {"a": j_agent.export_agent(a), "stream": j_agent.export_agent(b)}


def _port_tree(ref_snapshots):
    """The same agents through the port: imported, then exported."""
    return {t: t_agent.export_agent(t_agent.import_agent(s, "cpu"))
            for t, s in ref_snapshots.items()}


def _meta_text(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "meta.json")) as f:
        return f.read()


def test_port_tree_has_the_reference_leaf_keys(ref_snapshots):
    want = j_ckpt._leaf_paths(ref_snapshots)
    got = leaf_paths(_port_tree(ref_snapshots))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert len(got) == 88 and got[0][0] == "a/.params/b0"
    assert "stream/.opt_state/m/w0" in dict(got)
    assert "stream/.replay/.s" in dict(got)
    for (k, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def test_meta_json_equals_the_reference(tmp_path, ref_snapshots):
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    j_ckpt.CheckpointManager(jd, async_write=False).save(
        5, ref_snapshots, extras=EXTRAS)
    CheckpointManager(td, async_write=False).save(
        5, _port_tree(ref_snapshots), extras=EXTRAS)
    jm, tm = _meta_text(jd, 5), _meta_text(td, 5)
    assert json.loads(tm)["leaves"] == json.loads(jm)["leaves"]
    assert json.loads(tm)["extras"] == EXTRAS
    assert tm == jm                   # byte for byte, key order included
    rec = json.loads(tm)["leaves"]["stream/.rng"]
    assert rec["dtype"] == "uint32" and rec["shape"] == [2]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_side_restores_the_others_directory(tmp_path, ref_snapshots,
                                                 writer):
    d = str(tmp_path)
    if writer == "reference":
        j_ckpt.CheckpointManager(d, async_write=False).save(
            0, ref_snapshots, extras=EXTRAS)
        tmpl = {t: t_agent.agent_template(T_ACFG) for t in ref_snapshots}
        tree, info = CheckpointManager(d).restore(tmpl, device="cpu")
        got = [(k, v.numpy()) for k, v in leaf_paths(tree)]
    else:
        CheckpointManager(d, async_write=False).save(
            0, _port_tree(ref_snapshots), extras=EXTRAS)
        tmpl = {t: j_agent.agent_template(J_ACFG) for t in ref_snapshots}
        tree, info = j_ckpt.CheckpointManager(d).restore(tmpl)
        got = [(k, np.asarray(v)) for k, v in j_ckpt._leaf_paths(tree)]
    assert info["step"] == 0 and info["fallback_steps_skipped"] == 0
    assert info["tags"] == EXTRAS["tags"]
    want = j_ckpt._leaf_paths(ref_snapshots)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), k


def _tiny_tree(k=3):
    return {f"w{i}": np.arange(8, dtype=np.float32) * (i + k)
            for i in range(3)}


def test_atomic_commit_leaves_no_tmp_and_removes_a_stale_one(tmp_path):
    d = str(tmp_path)
    stale = os.path.join(d, "step_000000001.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "junk"), "w") as f:
        f.write("torn")
    mgr = CheckpointManager(d, async_write=False)
    mgr.save(0, _tiny_tree())
    assert sorted(os.listdir(d)) == ["step_000000000",
                                     "step_000000001.tmp"]
    assert mgr.all_steps() == [0]          # a .tmp is never a step
    mgr.save(1, _tiny_tree(4))
    assert sorted(os.listdir(d)) == ["step_000000000", "step_000000001"]
    assert sorted(os.listdir(os.path.join(d, "step_000000001"))) == [
        "meta.json", "shard_0.npz"]


@pytest.mark.parametrize("keep,want", [(2, [2, 3]), (0, [0, 1, 2, 3])])
def test_keep_bounds_the_history(tmp_path, keep, want):
    mgr = CheckpointManager(str(tmp_path), keep=keep, async_write=True)
    for s in range(4):
        mgr.save(s, _tiny_tree(s))
    mgr.wait()
    assert mgr.all_steps() == want and mgr.latest_step() == want[-1]


def test_wait_reraises_a_failed_async_write(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_write=True)

    def boom(*a, **kw):
        raise OSError("disk on fire")

    monkeypatch.setattr(t_ckpt.np, "savez", boom)
    mgr.save(0, _tiny_tree())
    with pytest.raises(OSError, match="disk on fire"):
        mgr.wait()
    monkeypatch.undo()
    mgr.save(1, _tiny_tree())             # the failure does not wedge it
    mgr.wait()
    assert mgr.all_steps() == [1]


def test_corrupt_newest_step_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=0, async_write=False)
    mgr.save(0, _tiny_tree(1))
    mgr.save(1, _tiny_tree(2))
    plan = faults.FaultPlan(seed=11)
    path = plan.corrupt_checkpoint(str(tmp_path), n_bytes=64)
    assert path.endswith("shard_0.npz") and "step_000000001" in path
    assert mgr.newest_intact_step() == 0 and not mgr.verify(1)
    tree, info = mgr.restore(_tiny_tree(9), device="cpu")
    assert info["step"] == 0 and info["fallback_steps_skipped"] == 1
    assert np.array_equal(tree["w0"].numpy(), _tiny_tree(1)["w0"])
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(_tiny_tree(9), step=1, device="cpu")
    plan.corrupt_checkpoint(str(tmp_path), step=0, target="meta")
    with pytest.raises(CheckpointCorruptError, match="no intact checkpoint"):
        mgr.restore(_tiny_tree(9), device="cpu")


def test_tampered_leaf_caught_by_its_crc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(0, _tiny_tree())
    faults.tamper_leaf(str(tmp_path), 0, "w1")
    arrays, _, bad = mgr.load_arrays(0)
    assert bad == {"w1"} and "w0" in arrays
    assert not mgr.verify(0)
    with pytest.raises(CheckpointCorruptError, match="w1"):
        mgr.restore(_tiny_tree(), step=0, device="cpu")
    # the reference's loader sees the same damage
    _, _, jbad = j_ckpt.CheckpointManager(str(tmp_path)).load_arrays(0)
    assert jbad == {"w1"}


def test_empty_directory_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        mgr.restore(_tiny_tree(), device="cpu")
    with pytest.raises(FileNotFoundError, match="nothing was ever saved"):
        mgr.read_meta()
    assert mgr.latest_step() is None and mgr.newest_intact_step() is None


def test_bf16_leaf_round_trips_and_the_reference_reads_it(tmp_path):
    g = torch.Generator().manual_seed(0)
    w = torch.randn((4, 8), generator=g).to(torch.bfloat16)
    tree = {"w": w, "f": torch.arange(3, dtype=torch.float32)}
    d = str(tmp_path)
    CheckpointManager(d, async_write=False).save(0, tree)
    meta = CheckpointManager(d).read_meta(0)
    assert meta["leaves"]["w"]["dtype"] == "bfloat16"
    back, _ = CheckpointManager(d).restore(
        {"w": torch.zeros((4, 8), dtype=torch.bfloat16),
         "f": torch.zeros(3)}, device="cpu")
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)
    jtree, _ = j_ckpt.CheckpointManager(d).restore(
        {"w": jnp.zeros((4, 8), jnp.bfloat16), "f": jnp.zeros(3)})
    assert jtree["w"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(jtree["w"]).view(np.uint16),
                          w.view(torch.int16).numpy().view(np.uint16))
    # and the port decodes a reference-written bf16 leaf to the same bits
    jd = str(tmp_path / "j")
    j_ckpt.CheckpointManager(jd, async_write=False).save(
        0, {"w": jnp.asarray(np.asarray(jtree["w"]))})
    tw, _ = CheckpointManager(jd).restore(
        {"w": torch.zeros((4, 8), dtype=torch.bfloat16)}, device="cpu")
    assert torch.equal(tw["w"], w)


def test_restore_places_leaves_on_the_requested_device(tmp_path):
    CheckpointManager(str(tmp_path), async_write=False).save(0, _tiny_tree())
    tree, _ = CheckpointManager(str(tmp_path)).restore(_tiny_tree(),
                                                       device="cpu")
    assert all(v.device.type == "cpu" for v in tree.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            CheckpointManager(str(tmp_path)).restore(_tiny_tree())
