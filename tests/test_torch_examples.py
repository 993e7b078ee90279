"""The port's examples (`examples/torch_*.py`) on the CPU, each through its
`main` at a small CLI size, against the reference's example on the same
arguments where it prints numbers from the same inputs.

Bars: the printed lines `==` (the demo's wall time aside).  The quickstart's
learned AIMM episode starts from a cold agent, whose `normal` init is
within 3 ulp of the reference's; on PR at 16384 ops that flips a decision,
so the test carries the reference's cold-start agent across
(`import_agent`, as tests/test_torch_episode_km.py), and the baseline line
needs nothing carried.  The demo's learned lanes are `==` from the port's
own cold agents.  The sharding search runs once on the reference's peaks
(`==`) and once on the H100 record (its own numbers).  `torch_train_lm.py`
draws weights of its own: its loss falls and an injected failure costs one
restart.
"""
import functools
import importlib.util
import re
import sys
from pathlib import Path

import pytest
import torch

from repro.core import agent as j_agent
from repro.core import sharding_mapper as j_sm
from repro.launch import roofline as j_rf
from repro_torch.core import agent as t_agent
from repro_torch.launch.roofline import Chip

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
REF = Chip(name="reference", peak_flops=j_rf.PEAK_FLOPS, hbm_bw=j_rf.HBM_BW,
           hbm_bytes=j_sm.HBM_PER_CHIP, link_bw=j_rf.ICI_BW)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs small eager ops: one intra-op thread takes the
    same wall time here and leaves the other cores to the other test
    workers, where more threads only spin on such small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(name, argv, monkeypatch, capsys) -> list[str]:
    mod = _load(name)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


def _run_port(name, argv, capsys) -> tuple[list[str], object]:
    capsys.readouterr()
    res = _load(name).main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines(), res


def test_quickstart_matches_the_reference(monkeypatch, capsys):
    argv = ["--episodes", "1"]
    want = _run_reference("quickstart", argv, monkeypatch, capsys)

    def cold_start(seed, cfg, n_agents=1, device="cuda"):
        from repro.nmp.config import NMPConfig
        from repro.nmp.engine import default_agent_cfg
        jag = j_agent.cold_start(seed, default_agent_cfg(NMPConfig()))
        return t_agent.import_agent(j_agent.export_agent(jag), device=device)
    monkeypatch.setattr(t_agent, "cold_start", cold_start)
    got, _ = _run_port("torch_quickstart", argv, capsys)
    assert len(got) == len(want) == 3
    assert got[0].startswith("BNMP baseline : OPC=")
    assert got == want


def test_demo_matches_the_reference(monkeypatch, capsys):
    argv = ["--n-ops", "2048", "--episodes", "1"]
    want = _run_reference("nmp_aimm_demo", argv, monkeypatch, capsys)
    got, _ = _run_port("torch_nmp_aimm_demo", argv, capsys)
    wall = re.compile(r"in [\d.]+s batched")
    assert len(got) == len(want) == 4
    assert [wall.sub("", s) for s in got] == [wall.sub("", s) for s in want]


def test_sharding_search_matches_the_reference(monkeypatch, capsys):
    argv = ["--arch", "qwen3-32b", "--steps", "60"]
    want = _run_reference("sharding_search", argv, monkeypatch, capsys)
    mod = _load("torch_sharding_search")
    monkeypatch.setattr(mod, "search", functools.partial(mod.search,
                                                         chip=REF))
    monkeypatch.setattr(mod, "exhaustive_best", functools.partial(
        mod.exhaustive_best, chip=REF))
    capsys.readouterr()
    mod.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 6
    assert got == want
    # on the H100 record: its own numbers, the same report
    card, _ = _run_port("torch_sharding_search", argv, capsys)
    assert len(card) == 6 and "OOM" not in card[2]
    assert re.search(r"RL vs optimum : [+-]\d+\.\d%", card[4])


def test_sharding_search_refuses_an_unknown_arch(capsys):
    with pytest.raises(SystemExit, match="unknown arch"):
        _run_port("torch_sharding_search", ["--arch", "nope"], capsys)


def test_train_lm_loss_falls_and_survives_a_failure(tmp_path, capsys):
    out, res = _run_port("torch_train_lm",
                         ["--steps", "10", "--inject-failure", "--ckpt-dir",
                          str(tmp_path / "ckpt")], capsys)
    assert res["restarts"] == 1
    L = res["losses"]
    assert len(L) == 15         # 5 steps before the failure, then 10
    assert L[-1] < L[0]
    assert out[0].startswith("model: ") and out[0].endswith("M params")
    assert "(1 restarts" in out[-1]
