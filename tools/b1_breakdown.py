#!/usr/bin/env python3
"""Kernels B1 and B2, or the probe kernels, against an older version of themselves on a CUDA card.

``python3 tools/b1_breakdown.py --old DIR [--out DIR] [--check-only]``

DIR holds the older version's ``remap_kernel.cu``, ``remap_device.cuh``
and ``rescue_kernel.cu``, and ``remap_frame.cu`` and ``rescue_windows.cu``
where that version has them (for example from ``git show
<commit>:image_lens_reproject_torch/csrc/<file>`` into a directory that
``.gitignore`` lists). The script builds that version with
``ops/cuda/build.py`` beside the package's own B1 and B2, then prints:

- the static SASS by class (``cuobjdump -sass``, from nvcc's directory) of
  the headline's and config 2's B1 full-frame and B2 instances, with
  registers, spill stores and stack frame from ``-Xptxas -v``, and each B2
  launch's CTAs an SM at the shared memory it reserves;
- both versions' full frame, raw library calls timed in turns (old, new,
  new, old; ``probes.loop_times``) at BASELINE configs 1-4 and the headline
  at batch 4, and at the headline with 2 x 2 and 3 x 3 supersamples at
  batch 1 and 4; the two versions and the plain path equal bit for bit;
- on config 2's plan (``ops/plan.py``) both versions' B1 list mode; and on
  the plans of config 2 (rescue and split lists) and the headline (rescue
  list), at batch 1 and 4, both versions' B2, each launched as its wrapper
  launches it (B2 before its redesign, without ``rescue_windows.cu``: one
  launch a list at its largest window; since, one launch a size class),
  raw calls in turns, bit for bit and with no read outside a window.

- the coordinate field: the new version's read instances
  (``remap_frame<IN, kFromField, ...>``, their field filled once by
  ``coord_field``) at the headline and config 2 (batch 1, and the headline
  at batch 4) against the older version's frame instances, raw calls in
  turns, bit for bit, with ``coord_field``'s own time; the SASS of every
  instance of B1 (frame, list, view, read and ``coord_field``) and of B2
  that the two versions share compared line for line (B2's registers are
  read only where this run built it), and the registers of the new read
  and ``coord_field`` instances;
  and the wrapper's path when every call brings a new rotation (the
  field's key and lookup, never a fill), host clock, against the older
  version's wrapper on the same calls (headline and config 1), where DIR
  also holds that version's ``ops/cuda/remap_kernel.py``.

``python3 tools/b1_breakdown.py --old DIR --probes [--alt DIR ...] [--out DIR]
[--check-only]`` does the same for the probe kernels K8 (``window_gather``),
K5 (``window_scan_db``), K4 (``window_copy``), K6 (``op_cost``, each op
class) and K7 (``lane_roll``), DIR holding an older ``dma_probe.cu``,
``ww2_probe.cu``, ``gather_cost_probe.cu`` or ``roll_probe.cu`` (those it
holds are compared): SASS by class, registers, spills and CTAs an SM of
each (for each ``op_cost<OP>``, also its trip loop's instructions by opcode
and per element-op), then raw calls timed in turns against the older
version at the timed shapes (K8: 8100 sub-tiles, bicubic, C = 3,
row-invariant and drift x0; K5: 2048 tiles x 4 steps; K4: 2048 tiles; K6:
4 tiles an SM at 256 trips; K7: 2048 (80, 256) tiles), every output bit for
bit with the plain version (K6 also on random keys at 0, 1 and 7 trips, K7
on every edge shape of ``roll_probe.edge_cases``). K7's package kernel is
also timed in turns against a copy of the same bytes (``out.copy_(x)``)
and against ``torch.gather`` with a stride-0 index, as ``chip_smoke.py``
times it. An older ``ilr_lane_roll`` without the ``vec`` argument is
called as the first design's was. It writes ``probes.json``. Each
``--alt`` directory holds a candidate design of some of those sources, with
the same C entry points, built and timed against the older version beside
the package's.

``--check-only`` builds, prints the SASS and checks every output, and times
nothing. The older kernels read the package's ``RemapParams``, which must
begin with their struct's fields, in their order. Everything printed is also
written to ``<out>/compare.json`` (``--out``, default
``tools/out/b1_breakdown/``, listed in ``.gitignore``). Needs one CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "tools" / "out" / "b1_breakdown"
# The instances whose SASS is printed: (in lens, out lens, sampler) codes.
STUDIED = {"headline": (4, 0, 2), "config 2": (2, 4, 1)}
# (config, batch, list) of the B2 timings.
B2_CASES = (("2", 1, "rescue"), ("2", 1, "split"), ("3", 1, "rescue"), ("3", 4, "rescue"),
            ("2", 4, "rescue"))
# Registers and CTAs of an H100 SM, for the CTAs an SM can hold.
SM_REGISTERS, SM_THREADS, B2_THREADS = 65536, 2048, 256
# (config, batch, n_samples) of the full-frame timings.
FRAME_CASES = (("1", 1, 1), ("2", 1, 1), ("3", 1, 1), ("4", 1, 1), ("3", 4, 1),
               ("3", 1, 2), ("3", 4, 2), ("3", 1, 3), ("3", 4, 3))

# SASS opcode (before its first '.') -> class.
CLASSES = {
    "fp32": "FADD FMUL FFMA FMNMX FSETP FSET FCHK FSWZADD FADD32I FMUL32I FFMA32I".split(),
    # Selects and byte permutes (integer-pipe instructions), predicate moves,
    # warp shuffles and barriers, apart from the arithmetic.
    "select": "SEL FSEL PRMT".split(),
    "predicate": "P2R R2P PLOP3 PSETP".split(),
    "shuffle": ["SHFL"],
    "barrier": ["BAR"],
    "fp64": "DADD DMUL DFMA DSETP DSET DMNMX".split(),
    "int": ("IMAD IADD3 IADD IADD32I LEA ISETP IMNMX LOP3 LOP LOP32I SHF SHL SHR IABS POPC FLO "
            "BREV IMUL ISCADD SGXT BMSK VIMNMX IDP ICMP ISET").split(),
    "conv": "F2I I2F F2F FRND I2FP F2IP F2FP I2I".split(),
    "mufu": ["MUFU"],
    "load": "LDG LD LDS LDC LDL LDSM LDGSTS ULDC".split(),
    "store": "STG ST STS STL RED ATOM ATOMG ATOMS".split(),
    "branch": "BRA BRX JMP JMX CALL RET EXIT BSSY BSYNC WARPSYNC BREAK BMOV YIELD".split(),
}
_CLASS_OF = {op: cls for cls, ops in CLASSES.items() for op in ops}
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def say(text: str) -> None:
    print(f"[b1_breakdown] {text}", flush=True)


def sass_listing(lib: Path):
    """Mangled kernel name -> its SASS lines (``cuobjdump -sass``)."""
    from image_lens_reproject_torch.ops.cuda import build

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    listing, current = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            current = line.split("Function : ")[1].strip()
            listing[current] = []
        elif current:
            listing[current].append(line)
    return listing


def class_counts(lines, opcodes=None):
    """{class: static SASS instruction count} of ``lines``, with each load and
    store opcode (and each of ``opcodes``) counted apart as ``op <OPCODE>``."""
    counts = {}
    for line in lines:
        m = _INSTR.search(line)
        if m:
            op = m.group(1).split(".")[0]
            cls = _CLASS_OF.get(op, "uniform" if op.startswith("U") else "other")
            counts[cls] = counts.get(cls, 0) + 1
            if cls in ("load", "store") or (opcodes and op in opcodes):
                counts["op " + op] = counts.get("op " + op, 0) + 1
    counts["total"] = sum(v for k, v in counts.items() if not k.startswith("op "))
    return counts


def sass_counts(lib: Path):
    """Mangled kernel name -> {class: static SASS instruction count}."""
    return {name: class_counts(lines) for name, lines in sass_listing(lib).items()}


def ptxas_info(report: str):
    """Mangled kernel name -> (registers, spill store bytes, stack frame bytes)."""
    info, current, frame, spill = {}, None, 0, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            frame, spill = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            info[current] = (int(m.group(1)), spill, frame)
            current = None
    return info


def ctas_per_sm(registers: int, smem_bytes: int, threads: int = B2_THREADS) -> int:
    """CTAs of ``threads`` threads (B2: 256) an H100 SM holds: threads,
    registers (allocated 8 a thread at a time) and shared memory (1 KB
    reserved a CTA)."""
    from image_lens_reproject_torch.ops import plan as P

    by_regs = SM_REGISTERS // (threads * (-(-registers // 8) * 8))
    by_smem = P.SM_SHARED_BYTES // (smem_bytes + P.CTA_RESERVED_BYTES)
    return min(SM_THREADS // threads, by_regs, by_smem)


def describe(label: str, lib: Path, report: str, kernel: str = "remap_frame"):
    """Prints and returns the SASS classes and registers of the studied
    instances of ``kernel`` (every specialisation of them)."""
    counts, info = sass_counts(lib), ptxas_info(report)
    say(f"{label}: {sum(f'{kernel}ILi' in n for n in counts)} instances of {kernel}")
    rows = {}
    for what, (i, o, s) in STUDIED.items():
        for name in sorted(n for n in counts if f"{kernel}ILi{i}ELi{o}ELi{s}E" in n):
            c = counts[name]
            rows[name] = {"studied": what, "sass": c, "ptxas": info.get(name)}
            parts = ", ".join(f"{k} {c.get(k, 0)}" for k in list(CLASSES) + ["uniform", "other"])
            ops = ", ".join(f"{k[3:]} {v}" for k, v in sorted(c.items()) if k.startswith("op "))
            say(f"{label} {what} {name}: total {c['total']} ({parts}; {ops}); registers, spill "
                f"bytes, stack bytes: {info.get(name)}")
    return rows


def turns(a, b, reps=20):
    """Medians of (a, b) in ms a call, timed as a, b, b, a."""
    from image_lens_reproject_torch.probes import loop_ms

    ta, tb = [], []
    for block in (ta, tb, tb, ta):
        block.append(loop_ms(b if block is tb else a, warmup=1, reps=reps))
    return statistics.median(ta), statistics.median(tb)


def same(torch, got, want) -> bool:
    """Bit-equal with NaN at the same places."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan]))


class Case:
    """A config's inputs, and raw calls of a library's ilr_remap_frame on them."""

    def __init__(self, torch, name, batch=1, n_samples=1):
        from image_lens_reproject_torch.baseline import configs
        from image_lens_reproject_torch.ops.cuda import remap_kernel as B1

        (h, w, c), kw, rot = configs()[name]
        self.kw = dict(dict(exposure=1.0, reinhard=1.0), **kw, n_samples=n_samples)
        self.torch, self.B1 = torch, B1
        dev = torch.device("cuda", 0)
        rng = np.random.default_rng(30 + int(name))
        self.src = torch.from_numpy(rng.uniform(0, 2, (batch, h, w, c)).astype(np.float32)).to(dev)
        self.rot = None if rot is None else torch.as_tensor(rot, dtype=torch.float32, device=dev)
        self.rot_np = rot
        self.p, _, self.stream = B1.launch_setup("b1_breakdown", self.src, rot, **self.kw)
        self.out = torch.empty((batch, kw["out_h"], kw["out_w"], c), device=dev)

    def launcher(self, lib):
        args = (self.src.data_ptr(), self.out.data_ptr(),
                None if self.rot is None else self.rot.data_ptr(), ctypes.byref(self.p), 0,
                self.stream)
        return lambda: check_rc(lib.ilr_remap_frame(*args))

    def result(self, lib):
        self.launcher(lib)()
        self.torch.cuda.synchronize()
        return self.out.clone()

    def plain(self):
        return self.B1.remap_tonemap_plain(self.src, self.rot_np, **self.kw)


def check_rc(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def frames(torch, old_lib, new_lib, record, check_only):
    record["times"] = {}
    for cfg, batch, n in FRAME_CASES:
        case = Case(torch, cfg, batch, n)
        got_new = case.result(new_lib)
        eq = same(torch, got_new, case.result(old_lib)) and same(torch, got_new, case.plain())
        if check_only:
            if not eq:
                raise RuntimeError(f"config {cfg} batch {batch} n {n}: B1 versions differ")
            continue
        o_ms, n_ms = turns(case.launcher(old_lib), case.launcher(new_lib))
        record["times"][f"{cfg} batch {batch} n {n}"] = {
            "old_ms": o_ms, "new_ms": n_ms, "frames": batch, "n_samples": n,
            "instance": [case.p.spec_channels, case.p.spec_samples], "bit_equal": eq}
        say(f"config {cfg} batch {batch} n_samples {n}: old B1 {o_ms:.4f} ms "
            f"({o_ms / batch:.4f} a frame), new B1 {n_ms:.4f} ms ({n_ms / batch:.4f} a frame), "
            f"{o_ms / n_ms:.2f}x; new instance (channels, samples) ({case.p.spec_channels}, "
            f"{case.p.spec_samples}); new == old == plain bit for bit: {eq}")
        if not eq:
            raise RuntimeError(f"config {cfg} batch {batch} n {n}: the two B1 or the plain "
                               f"path differ")


# (config, batch) of the coordinate field's timings.
FIELD_CASES = (("3", 1), ("2", 1), ("3", 4))
# (config, calls a run) of the miss path's host-clock timings; MISS_ROTATIONS
# distinct rotations, more than the field cache remembers, cycled.
MISS_CASES = (("3", 200), ("1", 400))
MISS_ROTATIONS = 1000


def field_reads(torch, old_lib, new_lib, record, check_only):
    """The new version's read instances, on a field that coord_field filled,
    against the older version's frame instances: raw calls in turns, bit for
    bit with each other and the plain path."""
    record["field"] = {}
    for cfg, batch in FIELD_CASES:
        case = Case(torch, cfg, batch)
        p = case.p
        field = torch.empty((p.band_rows, p.out_w, 2), device=case.src.device)

        def fill():
            check_rc(new_lib.ilr_coord_field(field.data_ptr(), ctypes.byref(p), 0, case.stream))

        def read():
            check_rc(new_lib.ilr_remap_field(case.src.data_ptr(), case.out.data_ptr(),
                                             field.data_ptr(), ctypes.byref(p), 0, case.stream))

        fill()
        read()
        torch.cuda.synchronize()
        got = case.out.clone()
        eq = same(torch, got, case.result(old_lib)) and same(torch, got, case.plain())
        label = f"config {cfg} batch {batch}"
        say(f"{label}: field read == old frame == plain bit for bit: {eq}")
        if not eq:
            raise RuntimeError(f"{label}: the field's read differs")
        if check_only:
            continue
        o_ms, n_ms = turns(case.launcher(old_lib), read)
        fill_ms = loop_ms_of(fill)
        record["field"][label] = {"old_frame_ms": o_ms, "read_ms": n_ms, "fill_ms": fill_ms,
                                  "frames": batch, "bit_equal": eq,
                                  "instance": [p.spec_channels, p.spec_samples]}
        say(f"{label}: old B1 frame {o_ms:.4f} ms ({o_ms / batch:.4f} a frame), new read "
            f"instance {n_ms:.4f} ms ({n_ms / batch:.4f} a frame), {o_ms / n_ms:.2f}x; "
            f"coord_field {fill_ms:.4f} ms (once a configuration)")
        del field, case


def loop_ms_of(fn, reps=20):
    from image_lens_reproject_torch.probes import loop_ms

    return loop_ms(fn, warmup=1, reps=reps)


def host_turns(torch, a, b, rounds=4):
    """Medians of (a, b) in ms a call on the host clock: each of them runs
    its calls and returns their number, timed from a synchronize to one,
    as a, b, b, a ``rounds`` times over."""
    import time

    ta, tb = [], []
    for _ in range(rounds):
        for fn, block in ((a, ta), (b, tb), (b, tb), (a, ta)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls = fn()
            torch.cuda.synchronize()
            block.append(1e3 * (time.perf_counter() - t0) / calls)
    return statistics.median(ta), statistics.median(tb)


def older_wrapper(old: Path):
    """The older version's ``ops/cuda/remap_kernel.py`` from ``old``, loaded as
    a module of the package beside the package's own (its library is the
    package's B1, built from ``csrc/``), or None where ``old`` has none."""
    import importlib.util

    path = old / "remap_kernel.py"
    if not path.exists():
        return None
    name = "image_lens_reproject_torch.ops.cuda._older_remap_kernel"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def bind_older(lib, signatures):
    """``build.bind`` of the entry points of ``signatures`` that an older
    library exports: one older than the view axis has no ``ilr_remap_views``,
    one older than the coordinate field no ``ilr_coord_field`` or
    ``ilr_remap_field``."""
    from image_lens_reproject_torch.ops.cuda import build

    return build.bind(lib, {n: a for n, a in signatures.items() if hasattr(lib, n)})


def miss_path(torch, old: Path, record, check_only):
    """``remap_tonemap`` with a new numpy rotation every call (the field's key
    and lookup, never a fill) against the older version's wrapper
    (``<old>/remap_kernel.py``) on the same calls, in turns on the host
    clock; skipped where ``old`` has no wrapper."""
    from image_lens_reproject_torch.baseline import configs
    from image_lens_reproject_torch.models.rotation import rotation_matrix_degrees
    from image_lens_reproject_torch.ops.cuda import build
    from image_lens_reproject_torch.ops.cuda import remap_kernel as B1

    older = older_wrapper(old)
    if older is None:
        say(f"miss path: {old} holds no remap_kernel.py, skipped")
        return
    rots = [rotation_matrix_degrees(0.36 * i, 5.0, 0.0) for i in range(MISS_ROTATIONS)]
    record["miss"] = {}
    for cfg, calls in MISS_CASES:
        (h, w, c), kw, _ = configs()[cfg]
        kw = dict(dict(exposure=1.0, reinhard=1.0), **kw, n_samples=1)
        rng = np.random.default_rng(50 + int(cfg))
        src = torch.from_numpy(rng.uniform(0, 2, (1, h, w, c)).astype(np.float32)).cuda()
        start = iter(range(0, 10**9, calls))

        def runner(wrapper):
            def run():
                i0 = next(start)
                for i in range(i0, i0 + calls):
                    wrapper.remap_tonemap(src, rots[i % MISS_ROTATIONS], **kw)
                return calls
            return run

        fills = build.COUNTS["b1.field_fill"]
        got = B1.remap_tonemap(src, rots[-1], **kw)
        eq = (same(torch, got, older.remap_tonemap(src, rots[-1], **kw))
              and same(torch, got, B1.remap_tonemap_plain(src, rots[-1], **kw)))
        say(f"config {cfg} miss path: bit for bit with the older wrapper and the plain path: "
            f"{eq}")
        if not eq:
            raise RuntimeError(f"config {cfg}: the miss path differs")
        if check_only:
            continue
        old_ms, new_ms = host_turns(torch, runner(older), runner(B1))
        record["miss"][f"config {cfg}"] = {"old_ms": old_ms, "new_ms": new_ms, "calls": calls,
                                           "fills": build.COUNTS["b1.field_fill"] - fills}
        say(f"config {cfg}, a new rotation every call, host clock: the older wrapper "
            f"{old_ms:.4f} ms a call, this one {new_ms:.4f} ms ({new_ms / old_ms:.3f}x); "
            f"fills {build.COUNTS['b1.field_fill'] - fills}")
    p, _, stream = B1.launch_setup("b1_breakdown", src, rots[0], **kw)
    dev = src.device
    keys = iter(range(10**9))
    cache = B1.FieldCache()
    nbytes = 8 * p.band_rows * p.out_w
    parts = {"capture check": torch.cuda.is_current_stream_capturing,
             "field_key": lambda: B1.field_key(p, dev, stream),
             "a first sighting's lookup": lambda: cache.lookup(next(keys), nbytes),
             "launch_mode of a first sighting": lambda: B1.launch_mode(
                 None, False, False, 1, p.has_rotation, False, B1.FIELD_BYPASS)}
    record["miss"]["host_us"] = {name: host_us(fn) for name, fn in parts.items()}
    say("the field's host work a call, us: " +
        ", ".join(f"{k} {v:.2f}" for k, v in record["miss"]["host_us"].items()))


def host_us(fn, n=20000):
    """Host µs a call of ``fn``, the median of three loops of ``n``."""
    import time

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / n)
    return statistics.median(runs)


# nvcc names an anonymous namespace after its translation unit and a hash
# that differs from build to build: _GLOBAL__N__<hash>_<n>_<file>_cu_<hash>,
# each hash 8 hex digits (the length of the next name follows at once, and
# a name may start with a hex letter: coord_field).
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def unmangled_unit(text: str) -> str:
    """``text`` with every anonymous namespace's build-specific name cut."""
    return _ANON.sub("_GLOBAL__N_", text)


def sass_equal(old_path: Path, new_path: Path, kernels=("remap_frame", "remap_views")):
    """{kernel: (instances both versions have, of them with equal SASS
    lines, the first differing line pair (old, new) of each instance that
    differs)}, instances matched by their mangled names with the anonymous
    namespaces' build-specific names cut, and so are their lines."""
    def listing(path):
        return {unmangled_unit(n): [unmangled_unit(line) for line in lines]
                for n, lines in sass_listing(path).items()}

    old, new = listing(old_path), listing(new_path)
    out = {}
    for kernel in kernels:
        shared = [n for n in old if f"{kernel}I" in n and n in new]
        differ = [next((a, b) for a, b in zip(old[n] + [""], new[n] + [""]) if a != b)
                  for n in shared if old[n] != new[n]]
        out[kernel] = (len(shared), len(shared) - len(differ), differ)
    return out


_FIELD_KERNEL = re.compile(r"\d+(remap_frameILi\dELi5E|coord_fieldI)")


def field_instances(new_path: Path, report: str):
    """{mangled name: (registers, spill bytes, stack bytes)} of the new read
    instances (``remap_frame<IN, 5, ...>``) and of coord_field."""
    info = ptxas_info(report)
    return {n: info.get(n) for n in sass_listing(new_path) if _FIELD_KERNEL.search(n)}


def plan_for(case):
    from image_lens_reproject_torch.ops import plan as P

    kw = case.kw
    return P.make_plan(case.rot_np, in_h=int(case.src.shape[1]), in_w=int(case.src.shape[2]),
                       channels=int(case.src.shape[3]), split=True, device=case.src.device,
                       **{k: kw[k] for k in ("in_lens", "out_lens", "out_h", "out_w", "interp")})


def b1_list(torch, libs, record, check_only):
    """Config 2's direct list: both versions' B1 list mode, raw calls in
    turns, outputs compared."""
    case = Case(torch, "2")
    plan = plan_for(case)
    rot = None if case.rot is None else case.rot.data_ptr()

    def make(side, out):
        args = (case.src.data_ptr(), out.data_ptr(), rot, plan.direct.data_ptr(),
                int(plan.direct.shape[0]), ctypes.byref(case.p), 0, case.stream)
        return lambda: check_rc(libs[side, "B1"].ilr_remap_list(*args))

    outs = {side: torch.full_like(case.out, float("nan")) for side in ("old", "new")}
    for side, out in outs.items():
        make(side, out)()
    torch.cuda.synchronize()
    eq = same(torch, outs["new"], outs["old"])
    if not eq:
        raise RuntimeError("config 2 B1 list: the two versions differ")
    if check_only:
        say(f"config 2 B1 list ({plan.direct.shape[0]} sub-tiles): new == old bit for bit")
        return
    o_ms, n_ms = turns(make("old", outs["old"]), make("new", outs["new"]))
    record["b1_list"] = {"old_ms": o_ms, "new_ms": n_ms, "bit_equal": eq}
    say(f"config 2 B1 list ({plan.direct.shape[0]} sub-tiles): old {o_ms:.4f} ms, new "
        f"{n_ms:.4f} ms ({o_ms / n_ms:.2f}x); new == old bit for bit")


def b2_instance(rows, codes, spec):
    """(name, registers) of the B2 instance of these lens and sampler codes
    and this (channels, samples) specialisation (None: an unspecialised B2)."""
    values = tuple(codes) + (tuple(spec) if spec is not None else ())
    key = "remap_windowsI" + "".join(f"Li{v}E" for v in values) + "EEv"
    for name, row in rows.items():
        if key in name and row["ptxas"]:
            return name, row["ptxas"][0]
    return None, None


def b2_launches(case, plan, split, old_layout):
    """(entries, count, window bytes, images a CTA or None) of each launch of
    B2 over one of the plan's lists, as that version's wrapper launched it:
    before the redesign (``old_layout``) one launch over the list in
    row-major order at its largest window (rows x cols x C float32) and no
    images argument; since, one launch a size class at the class's largest,
    ``images_per_cta`` images a CTA."""
    from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2

    entries, classes = ((plan.split, plan.split_classes) if split
                        else (plan.rescue, plan.rescue_classes))
    if old_layout:
        row_major = entries[(entries[:, 0].long() * plan.grid[1] + entries[:, 1]).argsort()]
        win = row_major[:, 2:].long().view(len(entries), -1, 4)
        floats = int((win[..., 1] * win[..., 3]).sum(-1).max()) * int(case.src.shape[3])
        return [(row_major, len(entries), 4 * floats, None)]
    launches, start = [], 0
    for count, floats in classes:
        images = B2.images_per_cta(int(case.src.shape[0]), 4 * floats)
        launches.append((entries[start:], count, 4 * floats, images))
        start += count
    return launches


def b2_compare(torch, libs, sass, old_layout, record, check_only):
    """Both versions' B2 on each of ``B2_CASES``: outputs compared, each
    launch's CTAs an SM printed, raw calls timed in turns."""
    record["b2"] = {}
    plans = {}
    for cfg, batch, which in B2_CASES:
        case = Case(torch, cfg, batch)
        plan = plans.setdefault(cfg, plan_for(case))
        split = which == "split"
        n_entries = len(plan.split if split else plan.rescue)
        if not n_entries:
            continue
        rot = None if case.rot is None else case.rot.data_ptr()
        misses = torch.zeros(1, dtype=torch.int64, device=case.src.device)
        launches = {side: b2_launches(case, plan, split, side == "old" and old_layout)
                    for side in ("old", "new")}

        def launcher(side, dst):
            lib = libs[side, "B2"]
            args = [(case.src.data_ptr(), dst.data_ptr(), rot, entries.data_ptr(), n, int(split),
                     n_bytes) + (() if images is None else (images,)) +
                    (ctypes.byref(case.p), misses.data_ptr(), 0, case.stream)
                    for entries, n, n_bytes, images in launches[side]]
            return lambda: [check_rc(lib.ilr_remap_windows(*a)) for a in args]

        outs = {side: torch.full_like(case.out, float("nan")) for side in launches}
        for side, out in outs.items():
            launcher(side, out)()
        torch.cuda.synchronize()
        eq = same(torch, outs["new"], outs["old"]) and int(misses.item()) == 0
        label = f"config {cfg} batch {batch} {which}"
        rec = {"entries": n_entries, "bit_equal": eq}
        codes = STUDIED["headline" if cfg == "3" else "config 2"]
        for side, parts in launches.items():
            spec = (None if side == "old" and old_layout
                    else (case.p.spec_channels, case.p.spec_samples))
            name, regs = b2_instance(sass.get(side, {}), codes, spec)
            shape = [[images or 1, n_bytes * (images or 1)] for _, _, n_bytes, images in parts]
            ctas = [ctas_per_sm(regs, smem) for _, smem in shape] if regs else None
            rec[side] = {"instance": name, "registers": regs, "launches": shape,
                         "ctas_per_sm": ctas}
            say(f"{label}: {side} B2: {len(shape)} launch(es), (images a CTA, shared bytes) "
                f"{shape}, {regs} registers, CTAs an SM {ctas}")
        record["b2"][label] = rec
        say(f"{label} ({n_entries} sub-tiles): new == old bit for bit, no read outside a "
            f"window: {eq}")
        if not eq:
            raise RuntimeError(f"{label}: the two B2 differ")
        if check_only:
            continue
        o_ms, n_ms = turns(launcher("old", outs["old"]), launcher("new", outs["new"]))
        rec.update(old_ms=o_ms, new_ms=n_ms)
        say(f"{label}: old B2 {o_ms:.4f} ms ({o_ms / batch:.4f} a frame), new {n_ms:.4f} ms "
            f"({n_ms / batch:.4f} a frame), {o_ms / n_ms:.2f}x")


def build_both(old: Path):
    """(libs, SASS record, old B2 layout): the old and the package's B1 and
    B2, built at once."""
    from image_lens_reproject_torch.ops.cuda import build
    from image_lens_reproject_torch.ops.cuda import remap_kernel as B1
    from image_lens_reproject_torch.ops.cuda import rescue_kernel as B2

    old_b1 = B1.SOURCES if (old / "remap_frame.cu").exists() else ("remap_kernel.cu",)
    old_layout = not (old / "rescue_windows.cu").exists()
    old_b2 = ("rescue_kernel.cu",) if old_layout else B2.SOURCES

    def load_old_b2():
        lib = bind_older(build.load("old_ilr_rescue", old_b2, old), B2.SIGNATURES)
        if old_layout:  # its launch function takes no images argument
            types = list(lib.ilr_remap_windows.argtypes)
            del types[7]
            lib.ilr_remap_windows.argtypes = types
        return lib

    jobs = {
        ("old", "B1"): lambda: bind_older(build.load("old_ilr_remap", old_b1, old),
                                          B1.SIGNATURES),
        ("old", "B2"): load_old_b2,
        ("new", "B1"): B1.library,
        ("new", "B2"): B2.library,
    }
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        libs = {key: f.result() for key, f in futures.items()}
    sass = {}
    for side, name, units, source_dir, kernel in (
            ("old", "old_ilr_remap", old_b1, old, "remap_frame"),
            ("new", B1.LIBRARY, B1.SOURCES, None, "remap_frame"),
            ("old", "old_ilr_rescue", old_b2, old, "remap_windows"),
            ("new", B2.LIBRARY, B2.SOURCES, None, "remap_windows")):
        seconds, report, unit_seconds = build.BUILD_INFO[name]
        if seconds is None:
            say(f"{name} was built before this run: no -Xptxas -v report for it")
        else:
            say(f"built {name} in {seconds:.1f} s; nvcc a file: " +
                "; ".join(f"{label} {s:.1f} s" for label, s in unit_seconds.items()))
        rows = describe(f"{side} {kernel}", build.library_path(name, units, source_dir), report,
                        kernel)
        sass.setdefault(side, {}).update(rows)
    old_path = build.library_path("old_ilr_remap", old_b1, old)
    new_path = build.library_path(B1.LIBRARY, B1.SOURCES)
    shared = sass_equal(old_path, new_path, ("remap_frame", "remap_views", "coord_field"))
    shared.update(sass_equal(build.library_path("old_ilr_rescue", old_b2, old),
                             build.library_path(B2.LIBRARY, B2.SOURCES), ("remap_windows",)))
    sass["shared"] = shared
    say("SASS of the instances both versions have, (shared, equal line for line): " +
        ", ".join(f"{k} {v[:2]}" for k, v in shared.items()))
    for kernel, (_, _, differ) in shared.items():
        for a, b in differ[:4]:
            say(f"{kernel}: a differing instance's first differing lines: {a!r} / {b!r}")
    if hasattr(libs["new", "B1"], "ilr_remap_field"):
        regs = field_instances(new_path, build.BUILD_INFO[B1.LIBRARY][1])
        sass["field_instances"] = regs
        for kind in ("remap_frame", "coord_field"):
            rows = {n: r for n, r in regs.items() if _FIELD_KERNEL.search(n).group(1).startswith(kind)}
            say(f"new {kind} field instances: {len(rows)}; (registers, spill bytes, stack bytes) "
                f"{sorted(set(r for r in rows.values() if r))}")
    return libs, sass, old_layout


# --- probe mode: kernels K8 (window_gather), K5 (window_scan_db), K4, K6 ---

# Threads a CTA and shared bytes a CTA of each probe kernel at the timed
# shapes (K8: one 8 x 128 window, with the new kernel's alignment slack;
# K5: two stages, none in the new kernel). op_cost's shared bytes are
# static, read from ptxas's report.
PROBE_SHAPES = {
    ("old", "window_gather"): (1024, 4096), ("new", "window_gather"): (256, 4 * 1028),
    ("old", "window_scan_db"): (256, 2 * 8192), ("new", "window_scan_db"): (256, 0),
    ("old", "window_copy"): (256, 8192), ("new", "window_copy"): (256, 8192),
    ("old", "lane_roll"): (256, 0), ("new", "lane_roll"): (256, 0),
}
PROBE_KERNELS = ("window_gather", "window_scan_db", "window_copy", "op_cost", "lane_roll")
# Source -> its C entry points.
PROBE_UNITS = {
    "dma_probe.cu": ("ilr_window_copy", "ilr_window_scan_db"),
    "ww2_probe.cu": ("ilr_window_gather",),
    "gather_cost_probe.cu": ("ilr_op_cost",),
    "roll_probe.cu": ("ilr_lane_roll",),
}
K6_ITERS = 256  # op_cost's trips where chip_smoke.py times it
# An op_cost trip: 16 ops on each of 32 values a thread (either layout).
K6_ELEMENT_OPS_PER_TRIP = 16 * 32
# Opcodes counted apart in op_cost's trip loop.
K6_OPCODES = set("SEL FSEL PRMT ISETP LOP3 P2R R2P SHFL LDS STS BAR FADD FMUL MOV IMAD".split())


def c_argtypes(source: str, name: str):
    """ctypes argument types of the C entry point ``name`` as ``source``
    declares it: pointers as c_void_p, the rest (ints) as c_int."""
    params = re.search(rf"\bint {name}\(([^)]*)\)", source).group(1).split(",")
    return [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]


def ptxas_smem(report: str):
    """Mangled kernel name -> static shared bytes, from ``-Xptxas -v``."""
    smem, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"Used \d+ registers.*?(\d+) bytes smem", line)
        if m and current:
            smem[current] = int(m.group(1))
            current = None
    return smem


_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/")
_TARGET = re.compile(r"\bBRA(?:\.\w+)*\s+(?:!?U?P\w+\s*,\s*)?(?:0x([0-9a-f]+)|`\(([^)]+)\))")


def trip_loop(lines):
    """The SASS lines of the longest loop of a kernel (from a backward
    branch's target to the branch): op_cost's trip loop."""
    addrs, labels, pending = [], {}, []
    for line in lines:
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
        m = _ADDR.search(line)
        if m and _INSTR.search(line):
            addr = int(m.group(1), 16)
            addrs.append((addr, line))
            for name in pending:
                labels[name] = addr
            pending = []
    best = []
    for addr, line in addrs:
        m = _TARGET.search(line)
        if not m:
            continue
        target = int(m.group(1), 16) if m.group(1) else labels.get(m.group(2))
        if target is not None and target < addr:
            body = [text for a, text in addrs if target <= a <= addr]
            if len(body) > len(best):
                best = body
    return best


def op_class(name: str) -> str:
    """op_cost<OP>'s class from its mangled name."""
    from image_lens_reproject_torch.probes import gather_cost_probe as GC

    return GC.OPS[int(re.search(r"op_costILi(\d)E", name).group(1))]


def probe_sass(label, lib_path, report):
    """Prints and returns SASS by class, registers and CTAs an SM of the
    probe kernels in one library; for op_cost, also its trip loop's
    instructions by opcode and per element-op."""
    listing, info, smem_of = sass_listing(lib_path), ptxas_info(report), ptxas_smem(report)
    rows = {}
    for name, lines in sorted(listing.items()):
        kernel = next((k for k in PROBE_KERNELS if k in name), None)
        if kernel is None:
            continue
        c = class_counts(lines)
        if kernel == "op_cost":
            threads, smem = 128, smem_of.get(name, 0)
        else:
            threads, smem = PROBE_SHAPES["old" if label == "old" else "new", kernel]
        regs = (info.get(name) or (None,))[0]
        ctas = ctas_per_sm(regs, smem, threads) if regs else None
        rows[name] = {"kernel": kernel, "sass": c, "ptxas": info.get(name), "threads": threads,
                      "smem_bytes": smem, "ctas_per_sm": ctas}
        parts = ", ".join(f"{k} {c.get(k, 0)}" for k in list(CLASSES) + ["uniform", "other"])
        ops = ", ".join(f"{k[3:]} {v}" for k, v in sorted(c.items()) if k.startswith("op "))
        what = f"{kernel} {op_class(name)}" if kernel == "op_cost" else name
        say(f"{label} {what}: total {c['total']} ({parts}; {ops}); registers, spill bytes, stack "
            f"bytes {info.get(name)}; {threads} threads, {smem} B shared: {ctas} CTAs an SM")
        if kernel == "op_cost":
            loop = class_counts(trip_loop(lines), K6_OPCODES)
            per = K6_ELEMENT_OPS_PER_TRIP
            rows[name]["trip_loop"] = loop
            rows[name]["per_element_op"] = {k: v / per for k, v in loop.items()}
            parts = ", ".join(f"{k} {v}" for k, v in sorted(loop.items())
                              if not k.startswith("op ") and v)
            ops = ", ".join(f"{k[3:]} {v} ({v / per:.3f})" for k, v in
                            sorted(loop.items(), key=lambda kv: -kv[1]) if k.startswith("op "))
            say(f"{label} op_cost {op_class(name)} trip loop: {loop['total']} instructions, "
                f"{loop['total'] / per:.3f} an element-op ({parts}); by opcode (an element-op): "
                f"{ops}")
    return rows


def build_probes(old: Path, alts):
    """(libraries, SASS record): the older probe sources in ``old``
    (``PROBE_UNITS``), the package's, and each candidate directory of
    ``alts`` (the probe sources it holds), built at once. Libraries: label
    -> (library, the entry points it has)."""
    from image_lens_reproject_torch import probes
    from image_lens_reproject_torch.ops.cuda import build

    dirs = {"old": old, **{f"alt {d.name}": d for d in alts}}
    units = {label: tuple(u for u in PROBE_UNITS if (d / u).exists()) for label, d in dirs.items()}
    with concurrent.futures.ThreadPoolExecutor(len(dirs) + 1) as pool:
        futures = {label: pool.submit(build.load, f"cmp_ilr_probes_{i}", units[label], d)
                   for i, (label, d) in enumerate(dirs.items())}
        futures["new"] = pool.submit(probes.library)
        libs = {label: f.result() for label, f in futures.items()}
    out, sass = {}, {}
    for i, (label, d) in enumerate(dirs.items()):
        text = "".join((d / unit).read_text() for unit in units[label])
        entries = tuple(e for unit in units[label] for e in PROBE_UNITS[unit])
        for name in entries:
            getattr(libs[label], name).restype = ctypes.c_int
            getattr(libs[label], name).argtypes = c_argtypes(text, name)
        out[label] = (libs[label], entries)
        sass[label] = (f"cmp_ilr_probes_{i}", units[label], d)
    out["new"] = (libs["new"], tuple(e for u in PROBE_UNITS.values() for e in u))
    sass["new"] = ("ilr_probes", probes.SOURCES, None)
    record = {}
    for label, (name, srcs, source_dir) in sass.items():
        seconds, report, _ = build.BUILD_INFO[name]
        if seconds is None:
            say(f"{name} was built before this run: no -Xptxas -v report for it")
        record[label] = probe_sass(label, build.library_path(name, srcs, source_dir), report)
    return out, record


def probe_compare(torch, old: Path, alts, record, check_only):
    """K8, K5, K4, K6 and K7: the older kernels against the package's (and
    each candidate's), raw calls in turns at the timed shapes, every output
    bit for bit with the plain version."""
    from image_lens_reproject_torch.probes import dma_probe as DP
    from image_lens_reproject_torch.probes import gather_cost_probe as GC
    from image_lens_reproject_torch.probes import roll_probe as RP
    from image_lens_reproject_torch.probes import ww2_probe as WW

    libs, record["sass"] = build_probes(old, alts)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    record["times"] = {}

    def run(label, entry, make, want, extra_checks=()):
        """Each library with ``entry``: its output (``make(lib)`` -> (call,
        out)) against ``want``, and on other inputs against each of
        ``extra_checks`` ((make, want) pairs); then timed in turns against
        the old one. Nothing when the old directory lacks ``entry``."""
        if entry not in libs["old"][1]:
            return
        variants = {key: make(lib) for key, (lib, entries) in libs.items() if entry in entries}
        outs = {}
        for key, (fn, out) in variants.items():
            checks = [(fn, out, want)] + [make_other(libs[key][0]) + (other_want,)
                                          for make_other, other_want in extra_checks]
            for call, got, expected in checks:
                call()
                torch.cuda.synchronize()
                outs[key] = outs.get(key, True) and torch.equal(got, expected)
        say(f"{label}: bit for bit with the plain version: {outs}")
        if not all(outs.values()):
            raise RuntimeError(f"{label}: a variant differs from the plain version")
        if check_only:
            return
        base = variants["old"][0]
        for key, (fn, _) in variants.items():
            if key == "old":
                continue
            o_ms, n_ms = turns(base, fn)
            record["times"][f"{label}: {key}"] = {"old_ms": o_ms, "new_ms": n_ms}
            say(f"{label}: old {o_ms:.4f} ms, {key} {n_ms:.4f} ms ({o_ms / n_ms:.2f}x)")

    # K6 at chip_smoke.py's timing shape: the probe's tile on 4 CTAs an SM,
    # K6_ITERS trips; checked also on random keys of both signs.
    x, idx = GC.check_inputs()
    n = GC.copies_for(dev)
    xb = torch.from_numpy(x).expand(n, 8, 128).contiguous().to(dev)
    ib = torch.from_numpy(idx).expand(n, 8, 128).contiguous().to(dev)
    rng = np.random.default_rng(4)
    xr = torch.from_numpy(rng.uniform(0, 1, (5, 8, 128)).astype(np.float32)).to(dev)
    ir = torch.from_numpy(rng.integers(-200, 200, (5, 8, 128)).astype(np.int32)).to(dev)

    def op_cost(x_, i_, op, iters):
        def make(lib):
            out = torch.empty_like(x_)
            args = (x_.data_ptr(), i_.data_ptr(), int(x_.shape[0]), GC.OPS.index(op), iters,
                    out.data_ptr(), 0, stream)
            return (lambda: check_rc(lib.ilr_op_cost(*args))), out
        return make

    for op in GC.OPS:
        run(f"op_cost {op}, {n} tiles x {K6_ITERS} trips", "ilr_op_cost",
            op_cost(xb, ib, op, K6_ITERS), GC.op_cost_plain(xb, ib, op, K6_ITERS),
            [(op_cost(xr, ir, op, iters), GC.op_cost_plain(xr, ir, op, iters))
             for iters in (0, 1, 7)])

    # K8 at the timed shape: 8100 sub-tiles, bicubic, C = 3, both kinds of x0.
    rng = np.random.default_rng(8)
    for drift in (False, True):
        win, y0, x0, wx, wy = (torch.from_numpy(a).to(dev) for a in
                               WW.case_inputs(rng, 8100, 1, 4, 3, drift=drift))
        n_sub, rows, cols = (int(d) for d in win.shape)
        want = WW.window_gather_plain(win, y0, x0, wx, wy, 3)
        ptrs = (win.data_ptr(), y0.data_ptr(), x0.data_ptr(), wx.data_ptr(), wy.data_ptr())

        def gather(lib):
            out = torch.empty_like(want)
            args = ptrs + (n_sub, rows, cols, 4, 3, out.data_ptr(), 0, stream)
            return (lambda: check_rc(lib.ilr_window_gather(*args))), out

        run(f"window_gather 8100 sub-tiles, {'drift' if drift else 'row-invariant'} x0",
            "ilr_window_gather", gather, want)

    # K5 and K4 at the timed table: 2048 tiles, 4 steps, the (512, 1024) source.
    rng, src, _, _ = DP.check_inputs()
    src = torch.from_numpy(src).to(dev)
    table = torch.from_numpy(DP.timing_table(rng)).to(dev)
    base = (src.data_ptr(), DP.H, DP.W, table.data_ptr(), int(table.shape[0]))
    want = DP.window_scan_db_plain(src, table, DP.N_STEPS)

    def scan(lib):
        out = torch.empty_like(want)
        args = base + (DP.N_STEPS, out.data_ptr(), 0, stream)
        return (lambda: check_rc(lib.ilr_window_scan_db(*args))), out

    run("window_scan_db 2048 tiles x 4 steps", "ilr_window_scan_db", scan, want)

    def copy(lib):
        out = torch.empty_like(want)
        return (lambda: check_rc(lib.ilr_window_copy(*base, out.data_ptr(), 0, stream))), out

    run("window_copy 2048 tiles", "ilr_window_copy", copy, DP.window_copy_plain(src, table))

    # K7 at the timed shape: the probe's 2048 (80, 256) tiles and shifts;
    # checked also on every edge shape.
    if "ilr_lane_roll" not in libs["old"][1]:
        return
    rng, _, _ = RP.check_inputs()
    xr, sr = RP.timing_inputs(rng, dev)

    def roll(x_, s_):
        def make(lib):
            out = torch.empty_like(x_)
            n, h, w = (int(d) for d in x_.shape)
            head = (x_.data_ptr(), s_.data_ptr(), n, h, w)
            if len(lib.ilr_lane_roll.argtypes) == 8:  # the first design's: no instance argument
                args = head + (out.data_ptr(), 0, stream)
            else:
                vec = RP.vector_instance(w, x_.data_ptr(), out.data_ptr())
                args = head + (int(vec), out.data_ptr(), 0, stream)
            return (lambda: check_rc(lib.ilr_lane_roll(*args))), out
        return make

    label = f"lane_roll {int(xr.shape[0])} x {tuple(xr.shape[1:])}"
    run(label, "ilr_lane_roll", roll(xr, sr), RP.lane_roll_plain(xr, sr),
        [(roll(x_, s_), RP.lane_roll_plain(x_, s_)) for x_, s_ in RP.edge_cases(dev)])
    if check_only:
        return
    fn, _ = roll(xr, sr)(libs["new"][0])
    dst = torch.empty_like(xr)
    copy_ms, kernel_ms = turns(lambda: dst.copy_(xr), fn)
    record["times"][f"{label}: a copy of the same bytes"] = {"copy_ms": copy_ms,
                                                              "new_ms": kernel_ms}
    say(f"{label}: torch's copy of the same bytes (out.copy_(x)) {copy_ms:.4f} ms, new "
        f"{kernel_ms:.4f} ms ({copy_ms / kernel_ms:.2f}x)")
    index = RP.roll_index(sr, int(xr.shape[2])).expand(xr.shape)
    gather_ms, kernel_ms = turns(lambda: torch.gather(xr, 2, index), fn)
    record["times"][f"{label}: torch.gather, stride-0 index"] = {
        "gather_ms": gather_ms, "new_ms": kernel_ms}
    say(f"{label}: torch.gather with a stride-0 index {gather_ms:.4f} ms, new {kernel_ms:.4f} ms "
        f"({gather_ms / kernel_ms:.2f}x)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old", type=Path, required=True,
                        help="directory holding the older version's kernel sources")
    parser.add_argument("--out", type=Path, default=OUT_DIR, help="directory for compare.json")
    parser.add_argument("--check-only", action="store_true",
                        help="build, print the SASS and check the outputs; time nothing")
    parser.add_argument("--probes", action="store_true",
                        help="the probe kernels K8, K5, K4, K6 and K7 instead of B1 and B2 "
                             "(DIR holds any of dma_probe.cu, ww2_probe.cu, gather_cost_probe.cu "
                             "and roll_probe.cu); writes probes.json")
    parser.add_argument("--alt", type=Path, action="append", default=[],
                        help="with --probes: a directory holding a candidate design of some "
                             "of those sources (same C entry points), timed against the old "
                             "version too; may be repeated")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("b1_breakdown needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    record = {"card": f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
                      f"{torch.__version__}, CUDA {torch.version.cuda}"}
    say(record["card"])
    if args.probes:
        probe_compare(torch, args.old.resolve(), [d.resolve() for d in args.alt], record,
                      args.check_only)
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "probes.json").write_text(json.dumps(record, indent=1))
        say(f"wrote {args.out / 'probes.json'}")
        return 0
    libs, sass, old_layout = build_both(args.old.resolve())
    record["sass"] = sass
    frames(torch, libs["old", "B1"], libs["new", "B1"], record, args.check_only)
    b1_list(torch, libs, record, args.check_only)
    if hasattr(libs["new", "B1"], "ilr_remap_field"):
        field_reads(torch, libs["old", "B1"], libs["new", "B1"], record, args.check_only)
        miss_path(torch, args.old.resolve(), record, args.check_only)
    b2_compare(torch, libs, sass, old_layout, record, args.check_only)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "compare.json").write_text(json.dumps(record, indent=1))
    say(f"wrote {args.out / 'compare.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
