"""Measure the PyTorch port's temporal-block window against its cluster
design on one NVIDIA card, in one process.

Run from the repository root on the machine with the card:

    python3 scripts/torch_tblock_designs.py [--sweep] [--out FILE]

It builds, with the flags of ``kernels/_build.py``:

* ``window``: the package's ``csrc/`` (its 64x64 window, one block an SM,
  the library the runners load), ``window_stamps``, the same with phase
  stamps (``scripts/tblock_phases/stamps.cuh``) inserted into a copy of its
  ``tblock_window.cuh`` at the end of the staging, of each step and of the
  write-back, and ``window_count``, the same with MRT pinned;
* ``cluster``: the cluster design of ``scripts/tblock_cluster/`` (not part
  of the package; ``cluster.py`` binds it) over the package's
  ``lbm_cell.cuh``, with ``cluster_stamps`` (through its own
  ``LBM_WINDOW_STAMP`` hooks) and ``cluster_count``;
* ``march``: the x-marching wavefront (``scripts/tblock_march/``, not
  part of the package) over the package's ``lbm_cell.cuh``.

Then (1) ``cuobjdump -sass`` of each library: per kernel, its
instructions, ``MUFU.RCP`` and ``CALL``; and every loop (a backward
branch) of the temporal-block kernels with its instructions, shared-memory
loads and stores, global loads and stores, barriers and cluster accesses.
A loop with no global access whose shared loads and stores are both 9 u
for some u is a step loop over u cells, and its instructions over u are
the instructions of one cell-step; the one with the fewest is the no-wall
path (``window_steps<false>``).  (2) The phase split: one launch at K = 5
of each stamped window at 2048^2, and one launch a shard at 4096^2 on a
2x2 mesh of the card, from the state 1 920 steps on; per block the
clock64() cycles of the staging, each step and the write-back, summed
over the blocks, their shares, the launch's span on the global timer, the
SM time no block held, and the achieved issue rate (warp instructions per
SM cycle) of the no-wall step loop.  (3) The package's ``tblock_step``
and the cluster design's (``cluster.SHAPE``) against ``pull_step``, and
both ``tblock_sharded_step`` against ``pull_sharded_step``, 60 steps from
a noisy state at 2048^2 and on a 2x2 mesh at 1024^2, the cluster design
in each shape of ``CHECK_SHAPES`` on the small and ragged fields of
``CHECK_FIELDS``, and the march against ``pull_step``: equal bit for bit,
or it raises.  (4) With ``--sweep``, at 2048^2 from the state 1 920 steps
on, the cluster design at each shape of ``SWEEP_SHAPES`` and each K of
``SWEEP_K`` (ms per step and the clusters the card holds at once).  (5) In
turns (forwards, then backwards), device ms per step by CUDA events over
1 920 steps at 1024^2, 2048^2 and 4096^2 MRT Re=5000, from rest and from
the state 1 920 steps on: ``pull_step``, the package's window at its K,
the cluster design at ``cluster.SHAPE`` and the same K, the march; and at
4096^2 on a 2x2 mesh of the card the package's sharded window against the
cluster design's, each through the sharded runner (the exchange kernel
between blocks, ``rdma``).  Prints one line per reading and writes them
all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import itertools
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from latticeboltzmannsimulations_torch import engine  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.kernels import (  # noqa: E402
    _build,
    pull,
    pull_sharded,
    tblock,
    tblock_sharded,
)
from latticeboltzmannsimulations_torch.parallel import (  # noqa: E402
    halo,
    make_mesh,
    shard_state,
    unshard_state,
)
from latticeboltzmannsimulations_torch.parallel.mesh import block_shape  # noqa: E402
from tblock_cluster import cluster  # noqa: E402

STEPS = 1_920
PHASE_K = tblock.K_STEPS
SIZES = (1024, 2048, 4096)
SWEEP_N = 2048
# (part rows, cluster x, cluster y) of the cluster design, and the K of the
# sweep
SWEEP_SHAPES = ((64, 1, 1), (64, 2, 1), (64, 4, 1), (64, 2, 2), (32, 2, 1), (32, 4, 1),
                (32, 8, 1), (16, 8, 1), (16, 16, 1))
SWEEP_K = (4, 5, 6, 8, 10)
# The cluster design's shapes of two blocks or more, each held to
# pull_step on small and ragged fields: along x with each part, a
# non-portable cluster of 16, and one that spans y too.
CHECK_SHAPES = ((64, 2, 1), (64, 2, 2), (32, 4, 1), (16, 8, 1), (16, 16, 1))
CHECK_FIELDS = ((63, 40, 5), (300, 109, 5), (129, 129, 8), (150, 200, 15), (520, 300, 1))
MARCH = (64, 0)   # the march's strip width and segment rows (0: its own choice)
SHARDED_N = 4096
SHARDED_MESH = (2, 2)
CHECK_STEPS = 60
WINDOW_CELLS = 64 * 64            # cells a block of the package's window steps
CLUSTER_CELLS = cluster.PART_CELLS   # and of the cluster design's part
SMS = 132
STAMPS = Path(__file__).resolve().parent / "tblock_phases" / "stamps.cuh"
STAMP_SLOTS = 40
# Where the stamps go in the package's window (a copy of its
# tblock_window.cuh): (anchor, text put after it).
WINDOW_HOOKS = (
    ("  __shared__ unsigned char xkey[kWin], ykey[kWin];\n", "  LBM_WINDOW_STAMP(0);\n"),
    ("rl[c] = a.lid_in(c / kWin);   // only lid cells read it\n  }\n  __syncthreads();\n",
     "  LBM_WINDOW_STAMP(1);\n"),
    ("      for (int k = 0; k < 9; ++k) win[slot(k, c, s)] = o[k];\n    }\n"
     "    __syncthreads();\n", "    LBM_WINDOW_STAMP(1 + s);\n"),
    ("    if (ykey[j] & kLid) a.lid_out(i, rl[c]);\n  }\n", "  LBM_WINDOW_STAMP(2 + k_steps);\n"),
)


def build(name: str, files: list, where: Path, stamped: bool = False,
          edits: tuple = ()) -> tuple[Path, str]:
    """nvcc every ``.cu`` of ``files`` (the headers among them beside it)
    into ``where/name.so``; a later file replaces an earlier one of the
    same name.  ``stamped``: the two temporal-block sources take the stamps
    header, each with its own setter (``lbm_stamps_<stem>``).  ``edits``:
    (file name, old text, new text) applied to the copies, each old text
    found exactly once.  Returns the library and ptxas's lines on
    registers and spills."""
    src = where / name
    src.mkdir()
    for path in files:
        shutil.copy(path, src / path.name)
    for file_name, old, new in edits:
        text = (src / file_name).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{file_name} has no single {old!r}")
        (src / file_name).write_text(text.replace(old, new))
    exe = _build.nvcc()
    objs, cmds = [], []
    for cu in sorted(src.glob("*.cu")):
        objs.append(src / f"{cu.stem}.o")
        extra = []
        if stamped and cu.stem.startswith("tblock"):
            extra = ["-include", str(STAMPS), f"-DLBM_STAMP_SETTER=lbm_stamps_{cu.stem}"]
        cmds.append([exe, *_build.COMPILE_FLAGS, *extra, "-c", "-o", str(objs[-1]), str(cu)])
    log = _build._run(cmds)
    lib = where / f"{name}.so"
    _build._run([[exe, *_build.LINK_FLAGS, "-o", str(lib), *map(str, objs)]])
    lines = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    for line in lines:
        print(f"  {name} ptxas: {line}", flush=True)
    return lib, "\n".join(lines)


# The counting builds: MRT without LES pinned in lbm_cell.cuh (the path the
# readings run), so that the cell loop holds only the instructions a cell
# executes.  This window steps the cells inside a part in a loop of their
# own, and those on an edge shared with another block in a second one.
PIN_MRT = (("lbm_cell.cuh", "  if (p.collision == SRT) {", "  if (false) {"),
           ("lbm_cell.cuh", "  } else if (p.collision == TRT) {", "  } else if (false) {"),
           ("lbm_cell.cuh", "  if (p.les != LES_NONE) {", "  if (false) {"))
WINDOW_FILES = ("tblock_step.cu", "tblock_sharded_step.cu", "tblock_window.cuh",
                "lbm_cell.cuh")


def stamped_window(where: Path) -> Path:
    """A copy of the package's tblock_window.cuh with the stamp hooks."""
    text = (_build.CSRC / "tblock_window.cuh").read_text()
    for anchor, hook in WINDOW_HOOKS:
        if text.count(anchor) != 1:
            raise AssertionError(f"the package's window has no single anchor {anchor!r}")
        text = text.replace(anchor, anchor + hook)
    (where / "hooked").mkdir()
    out = where / "hooked" / "tblock_window.cuh"
    out.write_text(text)
    return out


def declare_window(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The package's temporal-block entry points in a library built here
    and, where built, the stamp setters."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scalars = [i, i, fl, fl, fl, fl, fl, fl, fl, fl, fl, i, i, fl]
    lib.lbm_tblock_step.argtypes = [p, p, p, p, *scalars, i, p]
    lib.lbm_tblock_sharded_step.argtypes = [p, p, p, p, i, i, i, i, *scalars, i, p]
    fns = [lib.lbm_tblock_step, lib.lbm_tblock_sharded_step]
    for stem in ("tblock_step", "tblock_sharded_step"):
        setter = getattr(lib, f"lbm_stamps_{stem}", None)
        if setter is not None:
            setter.argtypes = [p]
            fns.append(setter)
    for fn in fns:
        fn.restype = ctypes.c_int
    return lib


def declare_march(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scalars = [i, i, fl, fl, fl, fl, fl, fl, fl, fl, fl, i, i, fl]
    lib.lbm_tblock_march_step.argtypes = [p, p, p, p, *scalars, i, i, i, p]
    lib.lbm_tblock_march_step.restype = ctypes.c_int
    return lib


def on(make, lib=None, shape=cluster.SHAPE):
    """The runner ``make()`` built and called with the cluster design's
    library ``lib`` in clusters of ``shape``, where ``lib`` is given (its
    graphs captured from it at its first call); else the package's."""
    def within():
        return (cluster.using(lib, shape) if lib is not None
                else contextlib.nullcontext())

    with within():
        runner = make()

    def run(state):
        with within():
            return runner(state)
    return run


def block_runner(entry, cfg: SimConfig, n: int, k: int, *shape):
    """n steps (n a multiple of k) of a temporal-block entry point of a
    built library (``shape``: the entry's arguments after K), ping-pong."""
    scalars = pull._scalars(cfg)

    def run(state):
        bufs = [engine.State(torch.empty_like(state.f), torch.empty_like(state.rho_lid))
                for _ in range(2)]
        src = (state.f.data_ptr(), state.rho_lid.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(n // k):
            dst = bufs[i % 2]
            err = entry(*src, dst.f.data_ptr(), dst.rho_lid.data_ptr(), *scalars, k,
                        *shape, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: error {err}")
            src = (dst.f.data_ptr(), dst.rho_lid.data_ptr())
        return bufs[(n // k - 1) % 2]

    return run


def mrt(n: int, **kw) -> SimConfig:
    return SimConfig(nx=n, ny=n, reynolds=5000.0, collision="mrt", precision="float32",
                     **kw).validate()


def noisy(cfg: SimConfig, device) -> engine.State:
    s = engine.init_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(7)
    return engine.State(s.f * (1.0 + 1e-3 * torch.randn(s.f.shape, generator=gen,
                                                         device=device)), s.rho_lid)


def further(cfg: SimConfig, device) -> engine.State:
    return pull.make_scan_runner(cfg, STEPS, device)(engine.init_state(cfg, device))


def sass(lib: Path, keep: Path) -> dict:
    """(1) per kernel function: instruction counts, and the loops of the
    temporal-block kernels with what they hold.  The SASS text is kept in
    ``keep``."""
    exe = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    keep.write_text(text)
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = {"ins": [], "labels": {}}
            continue
        if name is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            funcs[name]["labels"][m.group(1)] = None
            funcs[name]["pending"] = funcs[name].get("pending", []) + [m.group(1)]
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                      line)
        if m:
            addr = int(m.group(1), 16)
            for label in funcs[name].pop("pending", []):
                funcs[name]["labels"][label] = addr
            funcs[name]["ins"].append((addr, m.group(3), m.group(4)))
    out = {}
    for name, fn in funcs.items():
        ins = fn["ins"]
        c = {"instructions": len(ins),
             "MUFU.RCP": sum(op.startswith("MUFU.RCP") for _, op, _ in ins),
             "CALL": sum(op.startswith("CALL") for _, op, _ in ins)}
        if "tblock" in name and "march" not in name:
            c["loops"] = loops(ins, fn["labels"])
            steps = [lp for lp in c["loops"] if lp["cells"]]
            if steps:
                best = min(steps, key=lambda lp: lp["per_cell_step"])
                c["no_wall_per_cell_step"] = best["per_cell_step"]
        out[name] = c
    return out


def loops(ins: list, labels: dict) -> list:
    """Every backward branch's range [target, branch] with its counts."""
    found = []
    for at, (addr, op, rest) in enumerate(ins):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", rest)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1).startswith(".L") else int(m.group(1), 16)
        if target is None or target > addr:
            continue
        body = [o for a, o, _ in ins if target <= a <= addr]

        def n(prefix):
            return sum(o.startswith(prefix) for o in body)

        lp = {"from": hex(target), "to": hex(addr), "instructions": len(body),
              "LDS": n("LDS"), "STS": n("STS"), "LDG": n("LDG"), "STG": n("STG"),
              "BAR": n("BAR"), "LD": sum(o == "LD" or o.startswith("LD.") for o in body),
              "ST": sum(o == "ST" or o.startswith("ST.") for o in body),
              "UCGABAR": n("UCGABAR"), "MUFU.RCP": n("MUFU.RCP")}
        # a cell loop: 9 shared loads and 9 stores a cell (and, on a cluster
        # edge, up to 8 more loads from the inbox), no device access
        cells = 0
        if lp["LDG"] == lp["STG"] == 0 and lp["LDS"] >= 9 and lp["STS"] >= 9:
            cells = lp["STS"] // 9
        lp["cells"] = cells
        lp["per_cell_step"] = len(body) / cells if cells else None
        found.append(lp)
    return found


def phase_split(stamps: torch.Tensor, k: int, per_cell_step: float | None,
                cells_per_block: int, tiles: float | None = None) -> dict:
    """(2) from one launch's stamps (blocks, slots, 2).  The package's
    window stamps the staging, each step and the write-back of its one
    tile; the cluster design, persistent, stamps its first tile's staging
    and steps (its write-back is in step K) and then the end of its
    ``tiles`` tiles, the rest of which are read as one later-tile mean
    (``tiles`` None: the package's window)."""
    t = stamps[:, :, 0].double()
    clk = stamps[:, :, 1].double()
    last = 2 + k
    cyc = clk[:, 1:last + 1] - clk[:, 0:last]        # staging, steps, the rest
    sums = cyc.sum(0)
    total = float(sums.sum())
    span_ns = float(t[:, last].max() - t[:, 0].min())
    block_ns = float((t[:, last] - t[:, 0]).sum())
    ghz = float((clk[:, last] - clk[:, 0]).sum()) / block_ns
    nb = stamps.shape[0]
    out = {"blocks": nb, "span_us": span_ns / 1e3,
           "block_us_mean": block_ns / nb / 1e3,
           "sm_clock_ghz": ghz,
           "share": {"staging": float(sums[0]) / total,
                     "steps": float(sums[1:1 + k].sum()) / total,
                     "write_back" if tiles is None else "later_tiles":
                         float(sums[1 + k]) / total},
           "cycles_per_block": {"staging": float(sums[0]) / nb,
                                "step": float(sums[1:1 + k].sum()) / nb / k,
                                "steps": [float(v) / nb for v in sums[1:1 + k]]},
           # SM time in the launch's span that no block held (tails, gaps);
           # both windows run one block an SM
           "idle_sm_share": 1.0 - block_ns / (span_ns * SMS)}
    if tiles is None:
        out["cycles_per_block"]["write_back"] = float(sums[1 + k]) / nb
    else:
        out["tiles_per_block"] = tiles
        out["cycles_per_block"]["later_tile"] = (float(sums[1 + k]) / nb / (tiles - 1)
                                                 if tiles > 1 else None)
    if per_cell_step is not None:
        step_cycles = out["cycles_per_block"]["step"]
        out["warp_instructions_per_sm_cycle"] = (per_cell_step * cells_per_block / 32
                                                 / step_cycles)
    return out


def stamped_launch(setter, launch, blocks: int, k: int) -> torch.Tensor:
    """One launch with the stamps on; returns (blocks, slots, 2) as int64."""
    buf = torch.zeros(blocks * STAMP_SLOTS * 2, dtype=torch.int64, device="cuda")
    if setter(buf.data_ptr()) != 0:
        raise RuntimeError("the stamp setter failed")
    torch.cuda.synchronize()
    launch()
    torch.cuda.synchronize()
    if setter(None) != 0:
        raise RuntimeError("the stamp setter failed")
    out = buf.view(blocks, STAMP_SLOTS, 2)
    if bool((out[:, :3 + k, :] == 0).any()):
        raise AssertionError("a block left a stamp unwritten")
    return out


def phases(lib, shape, k: int, device, per_cell_step: dict) -> dict:
    """(2) one stamped launch at SWEEP_N^2 and one per shard at SHARDED_N^2
    on the 2x2 mesh; ``shape`` None for the package's window (entry points
    without a shape), else the cluster design's shape."""
    out = {}
    cfg = mrt(SWEEP_N)
    s = further(cfg, device)
    dst = engine.State(torch.empty_like(s.f), torch.empty_like(s.rho_lid))
    extra = () if shape is None else tuple(shape)
    held = None if shape is None else cluster.max_active_clusters(lib, shape)
    blocks = _blocks(cfg.nx, cfg.ny, k, shape, held)

    def single():
        err = lib.lbm_tblock_step(s.f.data_ptr(), s.rho_lid.data_ptr(), dst.f.data_ptr(),
                                  dst.rho_lid.data_ptr(), *pull._scalars(cfg), k, *extra,
                                  torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: error {err}")

    st = stamped_launch(lib.lbm_stamps_tblock_step, single, blocks, k)
    cells = WINDOW_CELLS if shape is None else CLUSTER_CELLS
    tiles = None if shape is None else _tiles(cfg.nx, cfg.ny, k, shape) / (
        blocks // (shape[1] * shape[2]))
    out[f"{SWEEP_N}^2"] = phase_split(st, k, per_cell_step.get("tblock_step"), cells, tiles)
    scfg = mrt(SHARDED_N, mesh_shape=SHARDED_MESH)
    mesh = make_mesh(SHARDED_MESH, [device] * 4)
    big = shard_state(further(mrt(SHARDED_N), device), mesh)
    lx, ly = block_shape(scfg.nx, scfg.ny, SHARDED_MESH)
    lay = halo.Layout.tight(lx, ly, k)
    carries = [halo.pad_blocks(big.f, lay)]
    carries.append(halo.empty_blocks(carries[0]))
    panels = [halo.pad_rows(big.rho_lid, k)]
    panels.append(halo.empty_blocks(panels[0]))
    halo.copy_pairs(halo.halo_pairs(carries[0], lay) + halo.row_halo_pairs(panels[0], k))
    blocks = _blocks(lx, ly, k, shape, held)
    tiles = None if shape is None else _tiles(lx, ly, k, shape) / (
        blocks // (shape[1] * shape[2]))
    reads = []
    for ix, iy in mesh.shards():
        def shard(ix=ix, iy=iy):
            err = lib.lbm_tblock_sharded_step(
                carries[0][ix][iy].data_ptr(), panels[0][ix][iy].data_ptr(),
                carries[1][ix][iy].data_ptr(), panels[1][ix][iy].data_ptr(), lx, ly,
                ix * lx, iy * ly, *pull._scalars(scfg), k, *extra,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: error {err}")
        reads.append(phase_split(stamped_launch(lib.lbm_stamps_tblock_sharded_step, shard,
                                                blocks, k),
                                 k, per_cell_step.get("tblock_sharded_step"), cells, tiles))
    out[f"{SHARDED_N}^2 mesh {SHARDED_MESH}"] = reads
    for name, r in out.items():
        for one in (r if isinstance(r, list) else [r]):
            print(f"  phases {name}: {json.dumps(one)}", flush=True)
    return out


def _blocks(nx: int, ny: int, k: int, shape, held: int | None) -> int:
    """The blocks of one launch: the package's 64x64 tiles (``shape``
    None), or the cluster design's persistent grid for ``shape``: as many
    clusters as the card holds at once (``held``), or as there are
    tiles."""
    if shape is None:
        own = 64 - 2 * k
        return -(-nx // own) * -(-ny // own)
    rows, cx, cy = shape
    return min(_tiles(nx, ny, k, shape), held) * cx * cy


def _tiles(nx: int, ny: int, k: int, shape) -> int:
    """The cluster design's tiles (clusters' own cells) on an nx x ny
    field."""
    ux, uy = cluster.tiles(nx, ny, k, shape)
    return ux * uy


def _check(name: str, a, b, device, sharded: bool, out: dict, steps: int) -> None:
    torch.cuda.synchronize()
    if sharded:
        a, b = unshard_state(a, device), unshard_state(b, device)
    equal = torch.equal(a.f, b.f) and torch.equal(a.rho_lid, b.rho_lid)
    out[name] = {"equal": equal, "max_abs_diff": (a.f - b.f).abs().max().item()}
    print(f"  {name}, {steps} steps: bit for bit {equal}", flush=True)
    if not equal:
        raise AssertionError(f"{name} differs")


def same_bits(libs: dict, device) -> dict:
    """(3) the package's window and the cluster design against the
    one-step kernels, the cluster design's other shapes on small and
    ragged fields, the march against pull_step."""
    out = {}
    cfg = mrt(SWEEP_N)
    s0 = noisy(cfg, device)
    lib = libs["cluster"]
    pull_run = pull.make_scan_runner(cfg, CHECK_STEPS, device)
    runs = {
        "window_vs_pull": tblock.make_scan_runner(cfg, CHECK_STEPS, device),
        "cluster_vs_pull": on(lambda: tblock.make_scan_runner(cfg, CHECK_STEPS, device), lib),
        "march_vs_pull": block_runner(libs["march"].lbm_tblock_march_step, cfg, CHECK_STEPS,
                                      5, *MARCH),
    }
    for name, run in runs.items():
        _check(name, run(s0), pull_run(s0), device, False, out, CHECK_STEPS)
    mcfg = mrt(1024, mesh_shape=SHARDED_MESH)
    mesh = make_mesh(SHARDED_MESH, [device] * 4)
    m0 = shard_state(noisy(mrt(1024), device), mesh)
    b = pull_sharded.make_sharded_runner(mcfg, CHECK_STEPS, mesh)(m0)
    for name, make_lib in (("window_sharded_vs_pull_sharded", None),
                           ("cluster_sharded_vs_pull_sharded", lib)):
        run = on(lambda: tblock_sharded.make_sharded_runner(mcfg, CHECK_STEPS, mesh,
                                                            halo_impl="rdma"), make_lib)
        _check(name, run(m0), b, device, True, out, CHECK_STEPS)
    for shape, (nx, ny, k) in itertools.product(CHECK_SHAPES, CHECK_FIELDS):
        fcfg = SimConfig(nx=nx, ny=ny, reynolds=1000.0, collision="mrt").validate()
        f0 = engine.init_state(fcfg, device)
        run = on(lambda: tblock.make_scan_runner(fcfg, 2 * k, device, k_steps=k), lib, shape)
        _check(f"cluster {shape} {nx}x{ny} K={k}", run(f0),
               pull.make_scan_runner(fcfg, 2 * k, device)(f0), device, False, out, 2 * k)
    return out


def time_ms(run, state) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(state)
    end.record()
    torch.cuda.synchronize()
    f = out.f if isinstance(out, engine.State) else out.f[0][0]
    if not bool(torch.isfinite(f).all()):
        raise AssertionError("non-finite populations")
    return start.elapsed_time(end) / STEPS


def sweep(lib, device, shapes=SWEEP_SHAPES, ks=SWEEP_K) -> dict:
    """(4) the cluster design's shapes and K at SWEEP_N^2, further on."""
    cfg = mrt(SWEEP_N)
    state = further(cfg, device)
    pull_ms = time_ms(pull.make_scan_runner(cfg, STEPS, device), state)
    out = {"pull_ms": pull_ms, "window": {}}
    print(f"  sweep {SWEEP_N}^2: pull_step {pull_ms:.5f} ms/step", flush=True)
    for shape, k in itertools.product(shapes, ks):
        key = f"rows={shape[0]} cluster={shape[1]}x{shape[2]} K={k}"
        reason = cluster.shape_reason(shape, k)
        held = cluster.max_active_clusters(lib, shape) if reason is None else 0
        if reason is None and held == 0:
            reason = "the card holds no such cluster"
        if reason is not None:
            out["window"][key] = {"refused": reason}
            print(f"  sweep {key}: refused ({reason})", flush=True)
            continue
        run = on(lambda: tblock.make_scan_runner(cfg, STEPS, device, k_steps=k), lib, shape)
        run(state)
        ms = time_ms(run, state)
        blocks = _blocks(cfg.nx, cfg.ny, k, shape, held)
        out["window"][key] = {"ms": ms, "clusters_at_once": held, "blocks": blocks}
        print(f"  sweep {key}: {ms:.5f} ms/step ({pull_ms / ms:.3f}x pull_step), "
              f"{held} clusters at once, {blocks} blocks", flush=True)
    return out


def in_turns(libs: dict, device) -> dict:
    """(5) the runners in turns at each size, from rest and further on, and
    the two sharded windows at SHARDED_N^2 on the 2x2 mesh."""
    out = {}
    lib = libs["cluster"]
    for n in SIZES:
        cfg = mrt(n)
        runners = {
            "pull": pull.make_scan_runner(cfg, STEPS, device),
            "window": tblock.make_scan_runner(cfg, STEPS, device),
            "cluster": on(lambda: tblock.make_scan_runner(cfg, STEPS, device), lib),
            "march": block_runner(libs["march"].lbm_tblock_march_step, cfg, STEPS, 5, *MARCH),
        }
        out[f"{n}"] = _turns(runners, cfg, device, f"{n}^2")
    scfg = mrt(SHARDED_N, mesh_shape=SHARDED_MESH)
    mesh = make_mesh(SHARDED_MESH, [device] * 4)
    runners = {
        "sharded_window": tblock_sharded.make_sharded_runner(scfg, STEPS, mesh,
                                                             halo_impl="rdma"),
        "sharded_cluster": on(lambda: tblock_sharded.make_sharded_runner(
            scfg, STEPS, mesh, halo_impl="rdma"), lib),
    }
    out[f"{SHARDED_N} mesh"] = _turns(runners, mrt(SHARDED_N), device,
                                      f"{SHARDED_N}^2 mesh {SHARDED_MESH}", mesh)
    return out


def _turns(runners: dict, cfg: SimConfig, device, label: str, mesh=None) -> dict:
    rest = engine.init_state(cfg, device)
    on_ = further(cfg, device)
    out = {}
    for name, state in (("rest", rest), ("further", on_)):
        if mesh is not None:
            state = shard_state(state, mesh)
        ms = {r: [] for r in runners}
        for r in runners:                      # warm-up
            runners[r](state)
        for r in list(runners) + list(reversed(runners)):
            ms[r].append(time_ms(runners[r], state))
        mean = {r: sum(v) / len(v) for r, v in ms.items()}
        out[name] = {"ms": ms, "mean": mean}
        first = next(iter(mean.values()))
        print(f"  {label} from {name}: " + ", ".join(
            f"{r} {mean[r]:.5f} ({first / mean[r]:.3f}x {next(iter(mean))})" for r in mean)
            + f"; turns {ms}", flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=Path, default=Path("output/tblock_designs.json"))
    parser.add_argument("--sweep", action="store_true",
                        help="also time the cluster design's shapes and K at 2048^2")
    parser.add_argument("--shapes", nargs="*",
                        help="the sweep's shapes as rows,cx,cy (default SWEEP_SHAPES)")
    parser.add_argument("--ks", nargs="*", type=int, help="the sweep's K (default SWEEP_K)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"  device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    window_files = [_build.CSRC / name for name in WINDOW_FILES]
    cluster_files = [_build.CSRC / "lbm_cell.cuh", *(cluster.DIR / n for n in cluster.SOURCES)]
    march_dir = Path(__file__).resolve().parent / "tblock_march"
    found = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp:
        where = Path(tmp)
        paths, ptxas = {}, {}
        paths["window"], ptxas["window"] = _build.ensure_built()
        for name, files, stamped, edits in (
                ("window_stamps", window_files + [stamped_window(where)], True, ()),
                ("window_count", window_files, False, PIN_MRT),
                ("cluster", cluster_files, False, ()),
                ("cluster_stamps", cluster_files, True, ()),
                ("cluster_count", cluster_files, False, PIN_MRT),
                ("march", [_build.CSRC / "lbm_cell.cuh", *sorted(march_dir.glob("*.cu*"))],
                 False, ())):
            paths[name], ptxas[name] = build(name, files, where, stamped, edits)
        found["ptxas"] = ptxas
        libs = {name: ctypes.CDLL(str(path)) for name, path in paths.items()}
        for name in ("window_stamps", "window_count"):
            declare_window(libs[name])
        for name in ("cluster", "cluster_stamps", "cluster_count"):
            cluster.declare(libs[name])
        declare_march(libs["march"])
        libs["window"] = _build.load_library()
        args.out.parent.mkdir(parents=True, exist_ok=True)
        found["sass"] = {name: sass(paths[name], args.out.with_suffix(f".{name}.sass"))
                         for name in ("window", "window_count", "cluster", "cluster_count")}
        per_cell = {}
        for name, counts in found["sass"].items():
            for fn, c in counts.items():
                if "tblock" in fn or "march" in fn:
                    print(f"  sass {name} {fn}: " + json.dumps(
                        {key: v for key, v in c.items() if key != "loops"}), flush=True)
                    for lp in c.get("loops", []):
                        print(f"    loop {json.dumps(lp)}", flush=True)
                    if "no_wall_per_cell_step" in c and name.endswith("_count"):
                        stem = "tblock_sharded_step" if "sharded" in fn else "tblock_step"
                        # the cluster design's kernels are templates on the
                        # part rows: keep its SHAPE's
                        if name == "cluster_count" and f"ILi{cluster.SHAPE[0]}E" not in fn:
                            continue
                        per_cell.setdefault(name[:-len("_count")], {})[stem] = (
                            c["no_wall_per_cell_step"])
        found["per_cell_step"] = per_cell
        print(f"  no-wall MRT instructions per cell-step: {per_cell}", flush=True)
        print(f"  phases of the package's window, K={PHASE_K}:", flush=True)
        found["phases"] = {"window": phases(libs["window_stamps"], None, PHASE_K, device,
                                            per_cell.get("window", {}))}
        print(f"  phases of the cluster design at {cluster.SHAPE}, K={PHASE_K}:", flush=True)
        found["phases"][f"cluster {cluster.SHAPE}"] = phases(
            libs["cluster_stamps"], cluster.SHAPE, PHASE_K, device, per_cell.get("cluster", {}))
        found["max_active_clusters"] = {
            f"rows={r} cluster={cx}x{cy}": cluster.max_active_clusters(libs["cluster"],
                                                                       (r, cx, cy))
            for r, cx, cy in SWEEP_SHAPES}
        print(f"  clusters the card holds at once: {found['max_active_clusters']}", flush=True)
        found["same_bits"] = same_bits(libs, device)
        if args.sweep:
            shapes = (tuple(tuple(int(v) for v in one.split(",")) for one in args.shapes)
                      if args.shapes else SWEEP_SHAPES)
            ks = tuple(args.ks) if args.ks else SWEEP_K
            found["sweep"] = sweep(libs["cluster"], device, shapes, ks)
        found["in_turns"] = in_turns(libs, device)
    args.out.write_text(json.dumps(found, indent=1))
    print(f"  written to {args.out}", flush=True)


if __name__ == "__main__":
    main()
