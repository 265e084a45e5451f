"""Compare the designs of the PyTorch port's temporal-block kernel on one
NVIDIA card, in one process, and show that the exact constant divisions
leave the other kernels' bits alone.

Run from the repository root on the machine with the card, with the
commit before this redesign unpacked (``git archive``) into a git-ignored
directory:

    python3 scripts/torch_tblock_designs.py --parent output/parent

It builds four libraries with the flags of ``kernels/_build.py``:

* ``parent``: the parent's ``csrc/`` (the 64x64-window temporal-block
  kernels, IEEE divisions by 6, 9, 12 and 36);
* ``step_a``: the parent's ``csrc/`` with this tree's ``lbm_cell.cuh`` (the
  window with the exact, cheap divisions: step A alone);
* ``this``: this tree's ``csrc/`` (the window of ``csrc/tblock_window.cuh``,
  shared by the two temporal-block kernels, with step A);
* ``march``: this tree's ``lbm_cell.cuh`` with ``scripts/tblock_march/``
  (the x-marching wavefront, measured here and not part of the package).

Then (1) ``pull_step`` and ``push_step`` at 1024^2 and ``pull_sharded_step``
at 1024^2 on a 2x2 mesh of the card, 64 steps from a seeded noisy state,
each through ``this`` and ``parent``: equal bit for bit, or it raises; and
the march (W = 64, K = 5) against ``this`` library's ``pull_step`` over 60
steps at 2048^2: equal bit for bit, or it raises; (2) in turns (forwards,
then backwards), device ms per step by CUDA events over 1 920 steps at
1024^2, 2048^2 and 4096^2 MRT Re=5000, from rest and from the state after
1 920 steps: ``pull_step`` of ``parent`` and of ``this``, the window at
K = 5 of ``parent``, of ``step_a`` and of ``this``, and the march at K = 5
(W = 64, ``MARCH``); (3) ``cuobjdump -sass`` counts per kernel of each
library: instructions, ``MUFU.RCP`` (IEEE divisions and integer divisions)
and ``CALL`` (the division's slow path).  With ``--sweep``, before (2): at
2048^2 from the state after 1 920 steps, the window at each K of
``SWEEP_K``, the march at each strip width of ``SWEEP_WIDTHS`` and K of
``SWEEP_K`` that fits, and the march at W = 64, K = 4 and 5 with its
segments cut for 2 to 24 blocks per SM.  Prints one line per reading and
writes them all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
    push,
    tblock,
)
from latticeboltzmannsimulations_torch.parallel import (  # noqa: E402
    make_mesh,
    shard_state,
    unshard_state,
)

STEPS = 1_920
WINDOW_K = 5
SWEEP_K = (4, 5, 6, 8, 10, 12, 16)
SWEEP_WIDTHS = (64, 128)
SWEEP_N = 2048
SMS = 132
MARCH = (64, 0)   # the march's strip width and segment rows (0: its own choice)
SEGMENT_BLOCKS_PER_SM = (2, 4, 6, 8, 12, 16, 24)
SIZES = (1024, 2048, 4096)
CHECK_STEPS = 64


def build(name: str, files: list, where: Path) -> Path:
    """nvcc every ``.cu`` of ``files`` (the headers among them beside it)
    into ``where/name.so``; a later file replaces an earlier one of the
    same name."""
    src = where / name
    src.mkdir()
    for path in files:
        shutil.copy(path, src / path.name)
    exe = _build.nvcc()
    objs = []
    cmds = []
    for cu in sorted(src.glob("*.cu")):
        objs.append(src / f"{cu.stem}.o")
        cmds.append([exe, *_build.COMPILE_FLAGS, "-c", "-o", str(objs[-1]), str(cu)])
    log = _build._run(cmds)
    lib = where / f"{name}.so"
    _build._run([[exe, *_build.LINK_FLAGS, "-o", str(lib), *map(str, objs)]])
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  {name} ptxas: {line.strip()}", flush=True)
    return lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points of the parent's and the march's libraries that this
    script calls, with their types (the march's ``lbm_tblock_march_step``
    takes the strip width and segment rows after K)."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scalars = [i, i, fl, fl, fl, fl, fl, fl, fl, fl, fl, i, i, fl]
    fns = []
    if hasattr(lib, "lbm_tblock_march_step"):
        lib.lbm_tblock_march_step.argtypes = [p, p, p, p, *scalars, i, i, i, p]
        fns.append(lib.lbm_tblock_march_step)
    else:
        lib.lbm_pull_step.argtypes = [p, p, p, p, p, *scalars, p]
        lib.lbm_push_step.argtypes = [p, p, *scalars, p]
        lib.lbm_pull_sharded_step.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                              *scalars[2:], p]
        lib.lbm_tblock_step.argtypes = [p, p, p, p, *scalars, i, p]
        fns += [lib.lbm_pull_step, lib.lbm_push_step, lib.lbm_pull_sharded_step,
                lib.lbm_tblock_step]
        lib.lbm_error_string.argtypes = [ctypes.c_int]
        lib.lbm_error_string.restype = ctypes.c_char_p
    for fn in fns:
        fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def using(lib):
    """The wrappers launch from ``lib`` inside the block."""
    saved = _build.load_library
    _build.load_library = lambda: lib
    try:
        yield
    finally:
        _build.load_library = saved


def on(lib, make):
    """The runner ``make()`` built and called with ``lib``'s kernels (its
    graphs captured from them at its first call)."""
    with using(lib):
        runner = make()

    def run(state):
        with using(lib):
            return runner(state)
    return run


def block_runner(entry, cfg: SimConfig, n: int, k: int, *shape):
    """n steps (n a multiple of k) of a temporal-block entry point of a
    built library (``shape``: the march's strip width and segment rows),
    ping-pong."""
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


def noisy(cfg: SimConfig, device) -> engine.State:
    s = engine.init_state(cfg, device)
    gen = torch.Generator(device=device).manual_seed(7)
    return engine.State(s.f * (1.0 + 1e-3 * torch.randn(s.f.shape, generator=gen,
                                                         device=device)), s.rho_lid)


def same_bits(libs: dict, device) -> dict:
    """(1) the three other kernels through ``this`` and ``parent``."""
    cfg = SimConfig(nx=1024, ny=1024, reynolds=5000.0, collision="mrt",
                    precision="float32").validate()
    s0 = noisy(cfg, device)
    out = {}
    runs = {
        "pull_step": lambda: pull.make_scan_runner(cfg, CHECK_STEPS, device)(s0),
        "push_step": lambda: engine.State(push.make_push_scan_runner(
            cfg, CHECK_STEPS, device)(s0.f), s0.rho_lid),
    }
    mesh_cfg = SimConfig(nx=1024, ny=1024, reynolds=5000.0, collision="mrt",
                         precision="float32", mesh_shape=(2, 2)).validate()
    mesh = make_mesh((2, 2), [device] * 4)
    runs["pull_sharded_step"] = lambda: unshard_state(pull_sharded.make_sharded_runner(
        mesh_cfg, CHECK_STEPS, mesh)(shard_state(s0, mesh)), device)
    for name, run in runs.items():
        got = {}
        for lib_name in ("this", "parent"):
            with using(libs[lib_name]):
                got[lib_name] = run()
        torch.cuda.synchronize()
        a, b = got["this"], got["parent"]
        equal = torch.equal(a.f, b.f) and torch.equal(a.rho_lid, b.rho_lid)
        diff = (a.f - b.f).abs().max().item()
        out[name] = {"equal": equal, "max_abs_diff": diff}
        print(f"  {name} this vs parent, {CHECK_STEPS} steps: bit for bit {equal}, "
              f"max|d| {diff:.3e}", flush=True)
        if not equal:
            raise AssertionError(f"{name}: the exact divisions changed its bits")
    big = SimConfig(nx=SWEEP_N, ny=SWEEP_N, reynolds=5000.0, collision="mrt",
                    precision="float32").validate()
    s0 = noisy(big, device)
    a = block_runner(libs["march"].lbm_tblock_march_step, big, 60, 5, *MARCH)(s0)
    with using(libs["this"]):
        b = pull.make_scan_runner(big, 60, device)(s0)
    torch.cuda.synchronize()
    equal = torch.equal(a.f, b.f) and torch.equal(a.rho_lid, b.rho_lid)
    out["march_vs_pull_step"] = {"equal": equal}
    print(f"  march {MARCH} K=5 vs pull_step, 60 steps at {SWEEP_N}^2: bit for bit "
          f"{equal}", flush=True)
    if not equal:
        raise AssertionError("the march differs from pull_step")
    return out


def time_ms(run, state) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = run(state)
    end.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.f).all()):
        raise AssertionError("non-finite populations")
    return start.elapsed_time(end) / STEPS


def in_turns(libs: dict, device) -> dict:
    """(2) the six runners in turns at each size, from rest and further on."""
    out = {}
    for n in SIZES:
        cfg = SimConfig(nx=n, ny=n, reynolds=5000.0, collision="mrt",
                        precision="float32").validate()
        this = libs["this"]
        runners = {
            "pull_parent": on(libs["parent"], lambda: pull.make_scan_runner(cfg, STEPS, device)),
            "window_parent": block_runner(libs["parent"].lbm_tblock_step, cfg, STEPS,
                                          WINDOW_K),
            "window_step_a": block_runner(libs["step_a"].lbm_tblock_step, cfg, STEPS,
                                          WINDOW_K),
            "window_this": on(this, lambda: tblock.make_scan_runner(cfg, STEPS, device,
                                                                    k_steps=WINDOW_K)),
            "march": block_runner(libs["march"].lbm_tblock_march_step, cfg, STEPS,
                                  WINDOW_K, *MARCH),
            "pull_this": on(this, lambda: pull.make_scan_runner(cfg, STEPS, device)),
        }
        rest = engine.init_state(cfg, device)
        further = runners["pull_this"](rest)
        for label, state in (("rest", rest), ("further", further)):
            ms = {name: [] for name in runners}
            for name in runners:                      # warm-up
                runners[name](state)
            order = list(runners) + list(reversed(runners))
            for name in order:
                ms[name].append(time_ms(runners[name], state))
            mean = {name: sum(v) / len(v) for name, v in ms.items()}
            out[f"{n}_{label}"] = {"ms": ms, "mean": mean}
            pull_ms = mean["pull_this"]
            print(f"  {n}^2 from {label}: " + ", ".join(
                f"{name} {mean[name]:.5f} ({pull_ms / mean[name]:.3f}x pull)"
                for name in runners) + f"; turns {ms}", flush=True)
        del further, rest
    return out


def sweep(libs: dict, device) -> dict:
    """The window's K and the march's shapes at SWEEP_N^2, from the state
    after STEPS steps."""
    cfg = SimConfig(nx=SWEEP_N, ny=SWEEP_N, reynolds=5000.0, collision="mrt",
                    precision="float32").validate()
    state = pull.make_scan_runner(cfg, STEPS, device)(engine.init_state(cfg, device))
    pull_ms = time_ms(pull.make_scan_runner(cfg, STEPS, device), state)
    out = {"pull_ms": pull_ms, "window": {}, "march": {}, "segments": {}}
    print(f"  sweep {SWEEP_N}^2: pull_step {pull_ms:.5f} ms/step", flush=True)

    def timed(run):
        run(state)
        return time_ms(run, state)

    for k in SWEEP_K:
        ms = out["window"][f"K={k}"] = timed(
            tblock.make_scan_runner(cfg, STEPS, device, k_steps=k))
        print(f"  sweep {SWEEP_N}^2 window K={k}: {ms:.5f} ms/step "
              f"({pull_ms / ms:.3f}x pull_step)", flush=True)
    entry = libs["march"].lbm_tblock_march_step
    for width in SWEEP_WIDTHS:
        for k in SWEEP_K:
            if 2 * k >= width or 4 * width * (72 + 40 * (k - 1)) > 232448:
                continue    # tblock_march.cuh: fits
            ms = out["march"][f"W={width} K={k}"] = timed(
                block_runner(entry, cfg, STEPS, k, width, 0))
            print(f"  sweep {SWEEP_N}^2 march W={width} K={k}: {ms:.5f} ms/step "
                  f"({pull_ms / ms:.3f}x pull_step)", flush=True)
    for k in (4, 5):
        strips = -(-SWEEP_N // (64 - 2 * k))
        for per_sm in SEGMENT_BLOCKS_PER_SM:
            segs = max(1, SMS * per_sm // strips)
            seg = -(-SWEEP_N // segs)
            ms = out["segments"][f"K={k} seg={seg}"] = timed(
                block_runner(entry, cfg, STEPS, k, 64, seg))
            print(f"  sweep {SWEEP_N}^2 march W=64 K={k}, {segs} segments of {seg} rows "
                  f"({strips * segs} blocks, {strips * segs / SMS:.2f} per SM): {ms:.5f} "
                  f"ms/step", flush=True)
    return out


def sass_counts(lib: Path) -> dict:
    """(3) instructions per kernel function in the library's SASS."""
    exe = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"instructions": 0, "MUFU.RCP": 0, "CALL": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None:
            op = m.group(1)
            c = counts[name]
            c["instructions"] += 1
            c["MUFU.RCP"] += op.startswith("MUFU.RCP")
            c["CALL"] += op.startswith("CALL")
    return counts


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True, type=Path,
                        help="a checkout of the commit before this redesign")
    parser.add_argument("--out", type=Path, default=Path("output/tblock_designs.json"))
    parser.add_argument("--sweep", action="store_true",
                        help="also time the schedules' shapes at 2048^2")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"  device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    parent_csrc = args.parent / "latticeboltzmannsimulations_torch" / "csrc"
    parent_files = sorted(parent_csrc.glob("*.cu*"))
    header = _build.CSRC / "lbm_cell.cuh"
    march_dir = Path(__file__).resolve().parent / "tblock_march"
    with tempfile.TemporaryDirectory() as tmp:
        where = Path(tmp)
        paths = {"parent": build("parent", parent_files, where),
                 "step_a": build("step_a", parent_files + [header], where),
                 "march": build("march", [header, *sorted(march_dir.glob("*.cu*"))],
                                where)}
        libs = {name: declare(ctypes.CDLL(str(path))) for name, path in paths.items()}
        paths["this"], _ = _build.ensure_built()
        libs["this"] = _build.load_library()
        found = {"device": smi, "same_bits": same_bits(libs, device),
                 "k_steps": tblock.K_STEPS, "window_k": WINDOW_K, "march": MARCH}
        found["sass"] = {name: sass_counts(path) for name, path in paths.items()}
        for name, counts in found["sass"].items():
            for fn, c in counts.items():
                if "step" in fn or "march" in fn:
                    print(f"  sass {name} {fn}: {c}", flush=True)
        if args.sweep:
            found["sweep"] = sweep(libs, device)
        found["in_turns"] = in_turns(libs, device)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(found, indent=1))
    print(f"  written to {args.out}", flush=True)


if __name__ == "__main__":
    main()
