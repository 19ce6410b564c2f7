"""chip_smoke.py's logic on the CPU: it refuses to run without a GPU,
picks its phases from --cards, reports a failing phase with a non-zero
exit and no result line, prints the result line in its exact format,
every phase's checks pass at small sizes on the host, and the
multigrid checks flag what they should."""
import json
import shutil
import subprocess
import sys
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest

import chip_smoke as cs
from cfd_demo_jax import Cylinder, Grid

ROOT = Path(__file__).resolve().parents[1]


def _run_script(cwd, *args):
    env = {"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
           "HOME": str(cwd), "TMPDIR": str(cwd)}
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_refuses_without_gpu(where, tmp_path):
    """No GPU: a non-zero exit and no result line, in the checkout and
    in a directory that holds the script and nothing else."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _run_script(cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("cards,want", [(1, cs.ONE_CARD),
                                        (4, cs.FOUR_CARDS)])
def test_cards_select_phases(cards, want):
    assert cs.select_phases(cards) == tuple(want)


def test_result_line_format():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = cs.result_line([dev])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')


def _fake_gpu(monkeypatch, phases):
    dev = SimpleNamespace(platform="gpu", device_kind="fake")
    monkeypatch.setattr(cs, "gpu_devices", lambda: [dev] * 4)
    monkeypatch.setattr(cs, "card_line", lambda: "fake, 700.00 W")
    monkeypatch.setattr(cs, "PHASES", phases)
    monkeypatch.setattr(cs.run_phases, "__defaults__",
                        (phases, sys.stdout))
    monkeypatch.setattr("cfd_demo_jax.runtime.compile_cache."
                        "enable_compile_cache", lambda: "")


def _boom():
    raise ValueError("boom")


def test_failing_phase_exits_nonzero_without_result(monkeypatch, capsys):
    phases = {name: (lambda: {"x": 1}) for name in cs.PHASES}
    phases["headline"] = _boom
    _fake_gpu(monkeypatch, phases)
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert "phase headline FAILED ValueError: boom" in out
    assert "phase ensemble" in out           # later phases still run
    assert '"ok"' not in out


@pytest.mark.parametrize("argv,count", [([], 4), (["--cards", "4"], 4)])
def test_passing_run_ends_with_the_result_line(monkeypatch, capsys, argv,
                                               count):
    phases = {name: (lambda: {"x": 1}) for name in cs.PHASES}
    _fake_gpu(monkeypatch, phases)
    assert cs.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    want = cs.FOUR_CARDS if argv else cs.ONE_CARD
    assert [ln.split()[1] for ln in lines[:-2]] == list(want)
    assert lines[-2] == "fake, 700.00 W"
    assert json.loads(lines[-1])["device"]["count"] == count


def test_too_few_gpus_is_refused(monkeypatch):
    _fake_gpu(monkeypatch, {})
    monkeypatch.setattr(cs, "gpu_devices", lambda: ["one"])
    assert cs.main(["--cards", "4"]) == 2


SMALL = {
    "reference": dict(grid=Grid(nx=64, ny=24, lx=8.0, ly=3.0,
                                obstacles=(Cylinder(2.0, 1.5, 0.4),)),
                      steps=12, compare_steps=6),
    "headline": dict(n=64, steps=3, mg_sizes=(131,)),
    "large": dict(n=96, steps=2),
    "ensemble": dict(batch=6, nx=48, ny=16, steps=4, compare=3),
    "rows": dict(n=64, steps=3, cards=4),
    "batch": dict(batch=8, nx=48, ny=16, steps=4, cards=4),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_phase_checks_pass_small_on_the_host(name):
    """Each phase end to end at a small size, the host CPU standing in
    for the card (the four-card phases on the virtual CPU mesh)."""
    assert len(jax.devices()) >= 4
    assert cs.run_phases([name], {name: partial(cs.PHASES[name],
                                                **SMALL[name])}) == 0


def test_invariants_catch_a_nonzero_wall_row():
    import dataclasses
    import cfd_demo_jax as cfd
    scene = cfd.make_scene(SMALL["reference"]["grid"])
    state = scene.init_state()
    cs.invariants(scene, state)
    bad = dataclasses.replace(state, u=state.u.at[0, 3].set(1.0))
    with pytest.raises(AssertionError, match="wall rows"):
        cs.invariants(scene, bad)


@pytest.mark.parametrize("n", [131, 200])
def test_mg_check_walks_the_aligned_hierarchy(n):
    """131: the odd interior aggregates into the bottom level; 200: one
    folded level (sweeps, residual) above a padded bottom."""
    mg = cs.mg_check(n, cycles=2)
    ops = set(mg["ops_card_vs_host"])
    assert {"smooth", "residual", "restrict", "prolong",
            "bottom_fdm"} <= ops
    assert ("sweeps" in ops) == (n == 200)
    first, last = mg["cycles"]
    assert first["host_vs_f64"] <= cs.FIXED_RTOL
    assert last["f64_vs_exact"] < first["f64_vs_exact"]  # it converges
    assert cs.mg_failures("mg", mg) == []


def _mg_result(op=0.0, bottom=2e-6, first=1e-7, last=1e-4, host_last=1e-4):
    cyc = lambda c, h: {"card_vs_f64": c, "host_vs_f64": h,
                        "card_vs_host": 0.0, "f64_vs_exact": 0.1}
    return {"ops_card_vs_host": {"restrict": op, "bottom_fdm": bottom},
            "cycles": [cyc(first, 1e-7), cyc(last, host_last)]}


@pytest.mark.parametrize("bad,match", [
    (dict(op=2e-6), "restrict"),
    (dict(bottom=2e-5), "bottom_fdm"),
    (dict(first=1e-4), "one V-cycle on the card"),
    (dict(last=3e-4), "further from float64"),
])
def test_mg_failures_flag_each_bound(bad, match):
    assert cs.mg_failures("mg", _mg_result()) == []
    (msg,) = cs.mg_failures("mg", _mg_result(**bad))
    assert match in msg


def test_on_host_f64_runs_the_same_program_in_float64():
    import jax.numpy as jnp
    import numpy as np
    x = np.full(3, 1.0 / 3.0, np.float32)
    out = cs.on_host_f64(lambda a, k: a * 3.0 - 1.0 + k, x, 2)
    assert out.dtype == jnp.float64
    assert list(out.devices())[0].platform == "cpu"
    np.testing.assert_allclose(np.asarray(out),
                               np.float64(x) * 3.0 - 1.0 + 2, rtol=0,
                               atol=1e-15)
