"""Probe: the cost of one tile-op of each op class a windowed kernel body is made of.

Port of the JAX package's ``bench/gather_cost_probe.py``. ``op_cost``
(kernel ``csrc/gather_cost_probe.cu`` ``op_cost<OP>``, replacing K6,
``make_kernel``) takes ``(n, 8, 128)`` float32 tiles ``x`` and int32 tiles
``idx`` and returns ``(n, 8, 128)``: for each tile, ``CHAINS`` chains start
at ``x + c``; each of ``iters`` trips applies the op ``UNROLL`` times to
every chain, then adds ``float32(i) * float32(1e-30)``; the result is the
chains' sum, ``((v0 + v1) + v2) + v3``. The op classes (``OPS``), with
``k = idx[t, r, j]``:

- ``fma``: ``v * 1.000001 + 0.5``, two float32 operations each rounded (the
  kernel is built with ``-fmad=false``);
- ``select``: ``v if k > 64 else v + 1``;
- ``lane_roll``: ``v[r, j] <- v[r, (j - 1) mod 128]``;
- ``sublane_gather``: ``v[r, j] <- v[k mod 8, j]``;
- ``lane_gather``: ``v[r, j] <- v[r, k mod 128]``.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts the kernel's launches.

``python -m image_lens_reproject_torch.probes.gather_cost_probe [--device
cpu]`` checks each class at ``CHECK_ITERS`` trips against the plain version
on the CPU, then on the card times ``copies`` identical tiles (``CTAS_PER_SM``
a streaming multiprocessor) at ``SMALL`` and ``BIG`` trips and prints, from
the difference, as the JAX probe did, ns per tile-op per SM: one JSON line
an op class, then the classes relative to ``fma`` and ``RESULT``.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from . import NOT_MEASURED, event_ms, expect, launch, parse_args

OPS = ("fma", "select", "lane_roll", "sublane_gather", "lane_gather")  # op codes 0..4
ROWS, LANES = 8, 128
UNROLL = 16  # ops per chain per trip
CHAINS = 4  # independent dependency chains
SMALL, BIG = 2048, 65536  # trip counts of the difference method
CHECK_ITERS = 64
CTAS_PER_SM = 4
REPS = 3
LAUNCHES = 0


def _check(x: torch.Tensor, idx: torch.Tensor, op: str, iters: int) -> None:
    expect("op_cost", x, "x", torch.float32, 3)
    expect("op_cost", idx, "idx", torch.int32, 3, x.device)
    if x.shape[1:] != (ROWS, LANES) or idx.shape != x.shape:
        raise ValueError(f"op_cost: x {tuple(x.shape)} and idx {tuple(idx.shape)} must both be "
                         f"(n, {ROWS}, {LANES})")
    if op not in OPS or iters < 0:
        raise ValueError(f"op_cost: op {op!r} not in {OPS}, or iters {iters} < 0")


def _fold(i: int) -> float:
    """The trip's term, rounded as float32 arithmetic rounds it."""
    return float(np.float32(i) * np.float32(1e-30))


def op_cost_plain(x: torch.Tensor, idx: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """The plain PyTorch version of ``op_cost``, on whatever device ``x`` lies:
    the chains as a dimension, (n, CHAINS, 8, 128)."""
    chains = torch.arange(CHAINS, dtype=torch.float32, device=x.device)[None, :, None, None]
    v = x[:, None] + chains
    k = idx[:, None].expand(v.shape)
    if op == "select":
        keep = k > 64
    elif op == "sublane_gather":
        k = torch.remainder(k, ROWS).long()
    elif op == "lane_gather":
        k = torch.remainder(k, LANES).long()
    for i in range(iters):
        for _ in range(UNROLL):
            if op == "fma":
                v = v * 1.000001 + 0.5
            elif op == "select":
                v = torch.where(keep, v, v + 1.0)
            elif op == "lane_roll":
                v = torch.roll(v, 1, dims=3)
            elif op == "sublane_gather":
                v = torch.gather(v, 2, k)
            else:
                v = torch.gather(v, 3, k)
        v = v + _fold(i)
    return ((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3]


def op_cost(x: torch.Tensor, idx: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """``(n, 8, 128)`` float32 and int32 -> ``(n, 8, 128)``: ``iters`` trips of ``op``."""
    global LAUNCHES
    _check(x, idx, op, iters)
    if x.device.type == "cpu":
        return op_cost_plain(x, idx, op, iters)
    out = torch.empty_like(x)
    if x.shape[0]:
        launch("ilr_op_cost", x, x.data_ptr(), idx.data_ptr(), int(x.shape[0]), OPS.index(op),
               int(iters), out.data_ptr())
        LAUNCHES += 1
    return out


def check_inputs():
    """The probe's inputs: x (1, 8, 128) uniform in [0, 1) from seed 0, and
    the permutation ``37 j mod 128`` on every row."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (1, ROWS, LANES)).astype(np.float32)
    perm = (np.arange(LANES, dtype=np.int32) * 37) % LANES
    idx = np.broadcast_to(perm, (1, ROWS, LANES)).copy()
    return x, idx


def copies_for(dev: torch.device) -> int:
    """Tiles a timing launch takes: CTAS_PER_SM on each streaming multiprocessor."""
    return CTAS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count


def time_op(op: str, x: torch.Tensor, idx: torch.Tensor, reps: int = REPS) -> dict:
    """CUDA-event medians of ``op`` at SMALL and BIG trips on the tiles of
    ``x``, and ns per tile-op per SM from their difference."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ms = {iters: event_ms(lambda: op_cost(x, idx, op, iters), warmup=1, reps=reps)
          for iters in (SMALL, BIG)}
    tile_ops_per_sm = (BIG - SMALL) * UNROLL * CHAINS * x.shape[0] / sms
    return {"op": op, "ns_per_tile_op_per_sm": (ms[BIG] - ms[SMALL]) * 1e6 / tile_ops_per_sm,
            "ms_small": ms[SMALL], "ms_big": ms[BIG], "copies": int(x.shape[0]), "sms": sms}


def main(argv: Optional[Sequence[str]] = None) -> int:
    dev = parse_args(argv, "Per-op-class costs: checks, then times on the card.")
    x, idx = check_inputs()
    x_cpu, idx_cpu = torch.from_numpy(x), torch.from_numpy(idx)
    if dev.type == "cuda":
        n = copies_for(dev)
        xb = x_cpu.expand(n, ROWS, LANES).contiguous().to(dev)
        ib = idx_cpu.expand(n, ROWS, LANES).contiguous().to(dev)
    ok_all = True
    results = {}
    for op in OPS:
        got = op_cost(x_cpu.to(dev), idx_cpu.to(dev), op, CHECK_ITERS).cpu()
        err = float((got - op_cost_plain(x_cpu, idx_cpu, op, CHECK_ITERS)).abs().max())
        rec = {"op": op, "max_err": err, "ok": err == 0}
        ok_all &= rec["ok"]
        if dev.type == "cuda":
            rec.update(time_op(op, xb, ib))
            results[op] = rec["ns_per_tile_op_per_sm"]
        print(json.dumps(rec), flush=True)
    if dev.type == "cpu":
        print(NOT_MEASURED)
    elif results["fma"] > 0:
        print(json.dumps({"relative_to_fma": {k: round(v / results["fma"], 2)
                                              for k, v in results.items()}}), flush=True)
    print("RESULT:", "PASS" if ok_all else "FAIL")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
