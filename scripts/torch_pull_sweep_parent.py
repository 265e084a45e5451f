"""Show that adding an entry to ``csrc/pull_step.cu`` (the sweep entry, the
tangential entry) leaves the one-cavity NEBB kernel ``pull_step`` as it
was, on one NVIDIA card, in one process.

Run from the repository root on the machine with the card, with the commit
before the new entry unpacked (``git archive``) into a git-ignored
directory:

    python3 scripts/torch_pull_sweep_parent.py --parent output/parent

It builds two libraries with the flags of ``kernels/_build.py``, ``parent``
from the parent's ``csrc/`` and ``this`` from this tree's, and then (1)
runs ``chip_smoke.py``'s six kernel-vs-plain cases of ``pull_step`` (20
steps from rest: SRT, TRT, MRT, MRT + Smagorinsky and SRT + Smagorinsky +
Van Driest at 128^2, MRT at 1024^2) through both, printing each library's
max |df| against the plain step and raising unless the two libraries give
the same bits; (2) times ``pull_step`` at 1024^2 MRT Re=5000 through both
in turns (parent, this, this, parent, parent, this), 1 920 steps per call by CUDA
events, from rest and from the state after 1 920 steps; (3) compares the
SASS of ``pull_step_kernel`` in the two libraries (``cuobjdump -sass``,
addresses stripped).  Prints one line per reading and writes them all as
JSON to ``--out``.
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
from latticeboltzmannsimulations_torch.kernels import _build, pull  # noqa: E402

STEPS = 1_920
CASES = {
    "srt": dict(collision="srt", reynolds=400.0),
    "trt": dict(collision="trt", reynolds=400.0),
    "mrt": dict(collision="mrt", reynolds=400.0),
    "mrt+smagorinsky": dict(collision="mrt", reynolds=5000.0, turbulence="smagorinsky"),
    "srt+smagorinsky+van_driest": dict(collision="srt", reynolds=5000.0,
                                       turbulence="smagorinsky", van_driest=True),
}


def build(name: str, csrc: Path, where: Path) -> Path:
    """nvcc every ``.cu`` of ``csrc`` (its headers beside it) into
    ``where/name.so``, as ``kernels/_build.py`` does."""
    src = where / name
    shutil.copytree(csrc, src)
    exe = _build.nvcc()
    objs, cmds = [], []
    for cu in sorted(src.glob("*.cu")):
        objs.append(src / f"{cu.stem}.o")
        cmds.append([exe, *_build.COMPILE_FLAGS, "-c", "-o", str(objs[-1]), str(cu)])
    log = _build._run(cmds)
    lib = where / f"{name}.so"
    _build._run([[exe, *_build.LINK_FLAGS, "-o", str(lib), *map(str, objs)]])
    kernel = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            kernel = re.search(r"(pull_\w+?_kernel)", line)
        elif kernel and "registers" in line:
            print(f"  {name} {kernel.group(1)}: {line.strip()}", flush=True)
    return lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lbm_pull_step`` and ``lbm_error_string``, the entries both
    libraries have."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scalars = [i, i, fl, fl, fl, fl, fl, fl, fl, fl, fl, i, i, fl]
    lib.lbm_pull_step.argtypes = [p, p, p, p, p, *scalars, p]
    lib.lbm_pull_step.restype = ctypes.c_int
    lib.lbm_error_string.argtypes = [ctypes.c_int]
    lib.lbm_error_string.restype = ctypes.c_char_p
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


def same_bits(libs: dict, device) -> dict:
    """(1) the six cases through both libraries."""
    out = {}
    cases = [(name, SimConfig(nx=128, ny=128, **kw)) for name, kw in CASES.items()]
    cases.append(("mrt 1024^2", SimConfig(nx=1024, ny=1024, reynolds=5000.0,
                                          collision="mrt")))
    for name, cfg in cases:
        s0 = engine.init_state(cfg, device)
        plain = s0
        step = engine.make_fused_step(cfg)
        for _ in range(20):
            plain = step(plain)
        got = {}
        for lib_name, lib in libs.items():
            with using(lib):
                got[lib_name] = pull.make_scan_runner(cfg, 20, device)(s0)
        torch.cuda.synchronize()
        errs = {k: (v.f - plain.f).abs().max().item() for k, v in got.items()}
        equal = (torch.equal(got["this"].f, got["parent"].f)
                 and torch.equal(got["this"].rho_lid, got["parent"].rho_lid))
        print(f"  pull {name}: max|df| against plain {errs}; this == parent: {equal}",
              flush=True)
        if not equal:
            raise AssertionError(f"pull_step {name}: this tree and the parent differ")
        out[name] = errs
    return out


def in_turns(libs: dict, device) -> dict:
    """(2) ms per step at 1024^2, parent and this in turns: a runner per
    library, its graphs captured from that library's kernel."""
    cfg = SimConfig(nx=1024, ny=1024, reynolds=5000.0, collision="mrt").validate()
    s0 = engine.init_state(cfg, device)
    runners = {}
    for lib_name, lib in libs.items():
        with using(lib):
            runners[lib_name] = pull.make_scan_runner(cfg, STEPS, device)
            s1 = runners[lib_name](s0)
    out = {}
    for label, s in (("rest", s0), ("further on", s1)):
        ms = {"parent": [], "this": []}
        for lib_name in ("parent", "this", "this", "parent", "parent", "this"):
            runner = runners[lib_name]
            with using(libs[lib_name]):
                runner(s)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                runner(s)
                end.record()
                torch.cuda.synchronize()
            ms[lib_name].append(start.elapsed_time(end) / STEPS)
        ratio = sum(ms["parent"]) / sum(ms["this"])
        print(f"  1024^2 pull_step from {label}, in turns: {ms} ms/step; this/parent "
              f"speed {ratio:.4f}x", flush=True)
        out[label] = dict(ms=ms, speed_ratio=ratio)
    return out


def sass(lib: Path) -> list[str]:
    """The instructions of ``pull_step_kernel`` in ``lib``."""
    exe = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    lines, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "pull_step_kernel" in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if inside and m:
            lines.append(m.group(1))
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the parent commit unpacked (its latticeboltzmannsimulations_torch/csrc)")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/pull_sweep_parent.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"parent": build("parent", args.parent / "latticeboltzmannsimulations_torch"
                                 / "csrc", Path(tmp)),
                 "this": build("this", _build.CSRC, Path(tmp))}
        libs = {name: declare(ctypes.CDLL(str(p))) for name, p in paths.items()}
        result = {"device": smi, "same_bits": same_bits(libs, device),
                  "in_turns": in_turns(libs, device)}
        code = {name: sass(p) for name, p in paths.items()}
        result["sass"] = {"instructions": {k: len(v) for k, v in code.items()},
                          "identical": code["this"] == code["parent"]}
        print(f"  pull_step_kernel SASS: {result['sass']}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
