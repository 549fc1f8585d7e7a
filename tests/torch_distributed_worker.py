"""One rank of a two-process gloo run of the port's ``parallel/`` on the CPU.

Started by tests/test_torch_distributed.py, one process per rank:

    python tests/torch_distributed_worker.py --coordinator localhost:PORT \
        --process-id 0 --mesh 1,2

``--mesh B,R``: the rank joins the group with ``distributed.init``, builds
the global (B, R) mesh, runs ``sharded_remap_step`` on a seeded batch and
checks its own shards, then the assembled output, against the
single-process port, bit for bit. With ``--rescue`` the step takes the
planned path inside each band, the rank planning its own band only
(``band_plans``). ``--cli IN OUT``: the rank runs the CLI with ``--device
cpu`` under torchrun's environment instead, with ``--mesh auto``, or with
``--mesh B,R --rescue on --split on`` given ``--rescue``. Prints
``DISTRIBUTED_OK`` on success. Imports neither JAX nor the JAX package.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLI_ARGS = [
    "--no-configs", "64,32", "--i-equirectangular", "full", "--rectilinear", "35,36",
    "--output-resolution", "64,27", "--rotation", "20,5,0", "--exposure", "1",
    "--reinhard", "4", "--bc", "--exr", "--device", "cpu", "--batch-size", "2",
]


def run_step(args) -> None:
    import numpy as np
    import torch

    from image_lens_reproject_torch.models.lens import Rectilinear, full_equirectangular
    from image_lens_reproject_torch.ops import plan as plan_mod
    from image_lens_reproject_torch.ops import remap_fused
    from image_lens_reproject_torch.ops.cuda import rescue_kernel
    from image_lens_reproject_torch.parallel import batch as pbatch
    from image_lens_reproject_torch.parallel import distributed

    active = distributed.init(args.coordinator, args.num_processes, args.process_id,
                              device="cpu", timeout=60)
    assert active, "distributed.init did not report an active group"
    b, r = (int(v) for v in (args.mesh or "1,2").split(","))
    mesh = distributed.global_mesh(batch=b, rows=r)
    mine = mesh.local_positions()
    assert len(mine) == 1, mine
    print(f"rank {distributed.process_index()} of {distributed.world_size()}: position {mine[0]}")

    batch = torch.from_numpy(np.random.default_rng(11).random((4, 32, 64, 3)).astype(np.float32))
    kw = dict(in_lens=full_equirectangular(), out_lens=Rectilinear(35.0, 36.0, 27.0),
              out_h=36, out_w=64, interp="bilinear", n_samples=1, exposure=2.0, reinhard=4.0)
    plans = misses = None
    if args.rescue:
        made = []
        real = plan_mod.make_plan

        def record(*a, **k):
            made.append((k["row_offset"], k["row_count"]))
            return real(*a, **k)

        plan_mod.make_plan = record
        plans = pbatch.band_plans(mesh, in_h=32, in_w=64, channels=3, **{
            k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w", "interp", "n_samples")})
        plan_mod.make_plan = real
        band = -(-kw["out_h"] // r)
        (i, j), = mine
        assert list(plans) == mine and made == [(j * band, band)], made
        misses = {mine[0]: rescue_kernel.new_misses("cpu")}
    out = pbatch.sharded_remap_step(pbatch.shard_batch(batch, mesh), None, mesh=mesh,
                                    plans=plans, misses=misses, **kw)
    if args.rescue:
        assert int(misses[mine[0]]) == 0
    want = remap_fused.remap_tonemap_batch(batch, None, **kw)
    assert list(out.shards) == mine
    for pos, shard in out.shards.items():
        assert torch.equal(shard, want[out.slices[pos]]), pos
    assert torch.equal(out.assemble(), want)
    assert distributed.local_batch_slice(4) == slice(2 * args.process_id, 2 * args.process_id + 2)


def run_cli(args) -> None:
    from image_lens_reproject_torch import cli

    host, port = args.coordinator.split(":")
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE=str(args.num_processes),
                      RANK=str(args.process_id), LOCAL_RANK=str(args.process_id))
    in_dir, out_dir = args.cli
    mesh = (["--mesh", args.mesh or "1,2", "--rescue", "on", "--split", "on"] if args.rescue
            else ["--mesh", args.mesh or "auto"])
    assert cli.main(CLI_ARGS + ["-i", in_dir, "-o", out_dir] + mesh) == 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--mesh")
    ap.add_argument("--rescue", action="store_true")
    ap.add_argument("--cli", nargs=2, metavar=("IN", "OUT"))
    args = ap.parse_args()

    import torch.distributed as dist

    try:
        if args.cli:
            run_cli(args)
        else:
            run_step(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"rank {args.process_id}: DISTRIBUTED_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
