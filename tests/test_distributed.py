"""Multi-host: a 2-process x 4-device CPU job (gloo collectives) runs
the GSPMD-sharded step on ONE global 8-device mesh and produces fields
bit-identical to the single-process 8-device run.

This is the process-boundary story the reference never had (its whole
comm stack is in-process mpsc, SURVEY.md section 2.7): every sharding
layout already spans jax.devices(), so after shard.distributed.
init_distributed the same code scales across hosts -- here pinned on
CPU, the same mechanism XLA uses across GPU hosts.
"""
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_CHILD = """
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
import jax
jax.config.update("jax_platforms", "cpu")
from cfd_demo_jax.shard.distributed import (gather_to_host,
                                            init_distributed,
                                            shutdown_distributed)
idx, cnt = init_distributed(coordinator_address=f"127.0.0.1:{port}",
                            num_processes=2, process_id=pid)
assert (idx, cnt) == (pid, 2)
assert len(jax.devices()) == 8, len(jax.devices())
import cfd_demo_jax as cfd
from cfd_demo_jax import (Cylinder, Grid, Semantics, SimulationParams,
                          solver_options_for)
from cfd_demo_jax.shard.mesh import make_mesh, make_sharded_step, shard_state
mesh = make_mesh()  # global: spans both processes
grid = Grid(nx=64, ny=64, lx=4.0, ly=4.0,
            obstacles=(Cylinder(1.0, 2.0, 0.4),))
scene = cfd.make_scene(grid, SimulationParams(dt=0.002, viscosity=1e-4),
                       solver_options_for(Semantics.RUST, ramp_up_steps=5))
state = shard_state(scene.init_state(), mesh)
step = make_sharded_step(scene, mesh)
for _ in range(5):
    state, diag = step(state)
print("RES", repr(float(diag.res_u)), repr(float(diag.res_p)), flush=True)
import numpy as np
u = gather_to_host(state.u)   # allgather: full field on every process
p = gather_to_host(state.p)

if pid == 0:
    np.savez(out, u=u, p=p)
shutdown_distributed()
"""


def test_two_process_gspmd_step_matches_single_process(tmp_path):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    out = str(tmp_path / "fields.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(i), str(port), out],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    results = _communicate_all(procs, timeout=300)
    for i, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"child {i}: {stderr[-2000:]}"
    res = [next(line for line in stdout.splitlines()
                if line.startswith("RES")).split()[1:]
           for stdout, _ in results]
    # both processes report the same (globally reduced) residuals
    assert res[0] == res[1]

    # single-process 8-device reference: identical scene + layout
    import cfd_demo_jax as cfd
    from cfd_demo_jax import (Cylinder, Grid, Semantics, SimulationParams,
                              solver_options_for)
    from cfd_demo_jax.shard.mesh import (make_mesh, make_sharded_step,
                                         shard_state)
    mesh = make_mesh()
    grid = Grid(nx=64, ny=64, lx=4.0, ly=4.0,
                obstacles=(Cylinder(1.0, 2.0, 0.4),))
    scene = cfd.make_scene(
        grid, SimulationParams(dt=0.002, viscosity=1e-4),
        solver_options_for(Semantics.RUST, ramp_up_steps=5))
    state = shard_state(scene.init_state(), mesh)
    step = make_sharded_step(scene, mesh)
    for _ in range(5):
        state, diag = step(state)
    with np.load(out) as data:
        # per-shard math is identical and the cross-shard reductions
        # are order-independent maxes: bit-exact, not just close
        np.testing.assert_array_equal(np.asarray(state.u), data["u"])
        np.testing.assert_array_equal(np.asarray(state.p), data["p"])
    assert float(diag.res_u) == float(res[0][0])
    assert float(diag.res_p) == float(res[0][1])


_ORBAX_CHILD = """
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; ckdir = sys.argv[3]; out = sys.argv[4]
import jax
jax.config.update("jax_platforms", "cpu")
from cfd_demo_jax.shard.distributed import (gather_to_host,
                                            init_distributed,
                                            shutdown_distributed)
init_distributed(f"127.0.0.1:{port}", 2, pid)
import numpy as np
import cfd_demo_jax as cfd
from cfd_demo_jax import (Cylinder, Grid, Semantics, SimulationParams,
                          solver_options_for)
from cfd_demo_jax.shard.mesh import make_mesh, make_sharded_step, shard_state
from cfd_demo_jax.runtime import checkpoint
mesh = make_mesh()
grid = Grid(nx=64, ny=64, lx=4.0, ly=4.0,
            obstacles=(Cylinder(1.0, 2.0, 0.4),))
scene = cfd.make_scene(grid, SimulationParams(dt=0.002, viscosity=1e-4),
                       solver_options_for(Semantics.RUST, ramp_up_steps=5))
state = shard_state(scene.init_state(), mesh)
step = make_sharded_step(scene, mesh)
for _ in range(3):
    state, diag = step(state)
checkpoint.save_orbax(ckdir, state)   # each process writes its shards
restored = checkpoint.load_orbax(ckdir, scene.init_state(), mesh=mesh)
assert np.array_equal(gather_to_host(state.u), gather_to_host(restored.u))
restored, d2 = step(restored)         # restored state steps on
print("ORBAX_OK", repr(float(d2.res_p)), flush=True)
# process_allgather is a collective: EVERY process must enter it, only
# the file write stays pid-0 (round-2 deadlock: gathers under the guard
# left process 0 stuck in the collective while 1 shut down).
u = gather_to_host(state.u)
p = gather_to_host(state.p)
if pid == 0:
    np.savez(out, u=u, p=p)
shutdown_distributed()
"""


def _communicate_all(procs, timeout):
    """communicate() every child; on timeout kill ALL of them so no
    CPU-eating orphans survive to slow the rest of the suite."""
    try:
        return [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        results = [p.communicate() for p in procs]
        raise AssertionError(
            "multi-process child timed out; outputs: "
            + " | ".join(f"child {i}: {err[-1500:]}"
                         for i, (_, err) in enumerate(results)))


def test_orbax_checkpoint_across_processes_elastic(tmp_path):
    """Elastic multi-host persistence: a 2-process job writes an orbax
    checkpoint (each process writes only its shards), round-trips it
    onto its own global mesh, and the SINGLE-process suite then
    restores the same checkpoint onto a different layout (8 devices,
    one process) bit-exactly -- the checkpoint's original process
    count and sharding are irrelevant on restore."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    child = tmp_path / "child.py"
    child.write_text(_ORBAX_CHILD)
    ckdir = str(tmp_path / "ck")
    out = str(tmp_path / "fields.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(child), str(i), str(port), ckdir, out],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    results = _communicate_all(procs, timeout=300)
    for i, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"child {i}: {stderr[-2000:]}"
        assert any(line.startswith("ORBAX_OK")
                   for line in stdout.splitlines())

    # cross-layout restore: single process, 8-device mesh
    import cfd_demo_jax as cfd
    from cfd_demo_jax import (Cylinder, Grid, Semantics, SimulationParams,
                              solver_options_for)
    from cfd_demo_jax.runtime import checkpoint
    from cfd_demo_jax.shard.mesh import make_mesh
    grid = Grid(nx=64, ny=64, lx=4.0, ly=4.0,
                obstacles=(Cylinder(1.0, 2.0, 0.4),))
    scene = cfd.make_scene(
        grid, SimulationParams(dt=0.002, viscosity=1e-4),
        solver_options_for(Semantics.RUST, ramp_up_steps=5))
    restored = checkpoint.load_orbax(ckdir, scene.init_state(),
                                     mesh=make_mesh())
    with np.load(out) as data:
        np.testing.assert_array_equal(np.asarray(restored.u), data["u"])
        np.testing.assert_array_equal(np.asarray(restored.p), data["p"])
