"""The port's ``parallel/distributed.py``: start-up, and a real two-process run.

``init`` is a no-op without torchrun's environment, honours
``ILR_DISTRIBUTED=0``, and returns False with the coordinator's error on
stderr when it cannot join (the JAX package's ``init`` swallows that
error). The two-process runs start ``tests/torch_distributed_worker.py``
twice, joined over gloo on localhost: the sharded step on meshes (1, 2)
and (2, 1), each rank checking its shards against the single-process
port (on (1, 2) also with the planned path inside each band, each rank
planning only its own band), and the CLI with ``--mesh auto``, or with
``--mesh 1,2 --rescue on --split on``, under torchrun's environment,
whose files must equal a one-process run's. Each process has a timeout
and is killed when it expires.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from image_lens_reproject_torch import cli
from image_lens_reproject_torch.io import exr
from image_lens_reproject_torch.ops import dispatch
from image_lens_reproject_torch.parallel import distributed

WORKER = Path(__file__).with_name("torch_distributed_worker.py")
sys.path.insert(0, str(WORKER.parent))
import torch_distributed_worker  # noqa: E402

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
WORKER_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_torchrun(monkeypatch):
    for name in TORCHRUN_ENV + ("ILR_DISTRIBUTED",):
        monkeypatch.delenv(name, raising=False)


def test_init_is_a_no_op_without_torchrun(no_torchrun):
    assert distributed.init(device="cpu") is False
    assert not dist.is_initialized()
    assert distributed.world_size() == 1 and distributed.process_index() == 0


def test_init_honours_the_opt_out(no_torchrun, monkeypatch):
    monkeypatch.setenv("ILR_DISTRIBUTED", "0")
    for name, value in zip(TORCHRUN_ENV, ("localhost", str(_free_port()), "2", "1", "1")):
        monkeypatch.setenv(name, value)
    assert distributed.init(device="cpu") is False
    assert not dist.is_initialized()


def test_init_reports_an_unreachable_coordinator(no_torchrun, capsys):
    """Rank 1 of 2 finds nothing listening: False, and the error on stderr."""
    address = f"localhost:{_free_port()}"
    assert distributed.init(address, 2, 1, device="cpu", timeout=1) is False
    assert not dist.is_initialized()
    err = capsys.readouterr().err
    assert f"cannot join the process group at tcp://{address} as rank 1 of 2" in err


def test_one_process_mesh_and_slice_without_a_group(no_torchrun):
    mesh = distributed.global_mesh()
    assert mesh.shape == {"batch": 1, "rows": 1} and mesh.ranks is None
    assert distributed.local_batch_slice(6) == slice(0, 6)


def _run_workers(extra, env=None):
    coordinator = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), "--coordinator", coordinator, "--process-id", str(pid),
             *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out}"
        assert f"rank {pid}: DISTRIBUTED_OK" in out, f"rank {pid} output:\n{out}"
    return outs


def _worker_env():
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.mark.parametrize("mesh,rescue", [("1,2", False), ("2,1", False), ("1,2", True)])
def test_two_process_sharded_step(mesh, rescue):
    outs = _run_workers(["--mesh", mesh] + ["--rescue"] * rescue, env=_worker_env())
    b, r = (int(v) for v in mesh.split(","))
    for rank, out in enumerate(outs):
        assert f"rank {rank} of 2: position {(rank // r, rank % r)}" in out


def test_two_process_cli_writes_the_one_process_files(tmp_path, no_torchrun):
    """torchrun's path: both ranks run the CLI with --mesh auto (a 2x1 mesh
    over the ranks); rank 0 writes, and the files equal a one-process run's."""
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(0)
    names = ("a.exr", "b.exr", "c.exr")
    for name in names:
        exr.write_exr(str(src / name), rng.uniform(0, 2, (32, 64, 3)).astype(np.float32))
    _run_workers(["--cli", str(src), str(tmp_path / "ranks")], env=_worker_env())
    args = torch_distributed_worker.CLI_ARGS
    assert cli.main(args + ["-i", str(src), "-o", str(tmp_path / "one")]) == 0
    for name in names:
        assert (tmp_path / "ranks" / name).read_bytes() == (tmp_path / "one" / name).read_bytes()


def test_two_process_cli_with_rescue_on_a_rows_mesh(tmp_path, no_torchrun):
    """Both ranks run the CLI with --mesh 1,2 --rescue on --split on: each
    plans and fills its own band, the misses are summed over the ranks, and
    rank 0's files equal a one-process --rescue on run's."""
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(1)
    names = ("a.exr", "b.exr")
    for name in names:
        exr.write_exr(str(src / name), rng.uniform(0, 2, (32, 64, 3)).astype(np.float32))
    _run_workers(["--cli", str(src), str(tmp_path / "ranks"), "--rescue"], env=_worker_env())
    args = torch_distributed_worker.CLI_ARGS + ["--rescue", "on", "--split", "on"]
    try:
        assert cli.main(args + ["-i", str(src), "-o", str(tmp_path / "one")]) == 0
    finally:
        dispatch.set_rescue_override(None)
        dispatch.set_split_override(None)
    for name in names:
        assert (tmp_path / "ranks" / name).read_bytes() == (tmp_path / "one" / name).read_bytes()
