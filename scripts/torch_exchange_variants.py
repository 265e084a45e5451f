"""Compare shapes of the PyTorch port's halo exchange kernel
(``csrc/halo_exchange.cu``) on one NVIDIA card, in one process.

Run from the repository root on the machine with the card:

    python3 scripts/torch_exchange_variants.py [--out output/exchange_variants.json]

It builds one library per variant of the kernel's constants (threads per
block, slots each thread has in flight, resident blocks per SM: one
``nvcc`` each, all started together, with the flags of ``kernels/_build.py``)
and prints each one's registers and spills.  Each variant is also run with
the wrapper's ``VECTOR_MIN`` changed where the variant names one (the row
length from which rows go by 16-byte lines; larger than any row: every
slot one float).  Then, on carry sets of a 4096^2 field on a 2x2 mesh of
the card filled from a seeded generator, it times one launch of each
table, in turns (the variants forwards, then backwards), as device ms with
the queue held busy (``chip_smoke.busy_time``):

* the whole refresh of the temporal-block runner's carries (tight, K=5,
  with lid panels);
* the whole refresh of the one-step runner's carries (aligned, depth 1);
* the x-only table of the JAX contract (tight, K=5);
* the first refresh split into its y strips alone and the rest alone, and
  one float alone (the launch's floor).

Every variant's result is held to the refresh's phases copied in order, byte
for byte, or it raises.  Prints one line per reading and writes them all as
JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from latticeboltzmannsimulations_torch.kernels import _build, halo_rdma  # noqa: E402
from latticeboltzmannsimulations_torch.parallel import halo  # noqa: E402

N = 4096
MESH = (2, 2)
K = 5
REPS = 200
SOURCE = _build.CSRC / "halo_exchange.cu"
# name: (kThreads, kItems, kBlocksPerSm, VECTOR_MIN); the first is the tree's
VARIANTS = {
    "tree": (512, 4, 2, halo_rdma.VECTOR_MIN),
    "threads256": (256, 4, 4, halo_rdma.VECTOR_MIN),
    "items2": (256, 2, 8, halo_rdma.VECTOR_MIN),
    "items8": (256, 8, 2, halo_rdma.VECTOR_MIN),
    "threads128": (128, 4, 8, halo_rdma.VECTOR_MIN),
    "blocks8": (256, 4, 8, halo_rdma.VECTOR_MIN),
    "all_floats": (512, 4, 2, 1 << 30),
    "vector8": (512, 4, 2, 8),
}


def variant_source(threads: int, items: int, blocks: int) -> str:
    text = SOURCE.read_text()
    for name, value in (("kThreads", threads), ("kItems", items), ("kBlocksPerSm", blocks)):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise RuntimeError(f"{name} not found once in {SOURCE.name}")
    return text


def build(tmp: Path) -> dict:
    """One library per variant of the constants, built all at once."""
    shapes = sorted({v[:3] for v in VARIANTS.values()})
    cmds, paths = [], {}
    for shape in shapes:
        src = tmp / ("halo_%d_%d_%d.cu" % shape)
        src.write_text(variant_source(*shape))
        paths[shape] = tmp / (src.stem + ".so")
        cmds.append([_build.nvcc(), *_build.COMPILE_FLAGS, "-shared", "-o",
                     str(paths[shape]), str(src)])
    log = _build._run(cmds)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    libs = {}
    for shape, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.lbm_halo_exchange.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.lbm_halo_exchange.restype = ctypes.c_int
        libs[shape] = lib
    return libs


def cases(device):
    """(name, carries, panels, moves, phases of) of the three tables;
    ``phases of(carries, panels)`` is the plain version on other blocks."""
    out = []
    for name, depth, kind, x_only in (("refresh tight K=5", K, "tight", False),
                                      ("refresh aligned depth 1", 1, "aligned", False),
                                      ("x-only tight K=5", K, "tight", True)):
        lay = getattr(halo.Layout, kind)(N // MESH[0], N // MESH[1], depth)
        carries, panels = chip_smoke.random_carries(device, MESH, lay)
        if kind == "aligned":
            panels = None
        if x_only:
            def phases_of(c, p, lay=lay):
                return [halo_rdma.x_moves(c, p, lay)]
            moves = phases_of(carries, panels)[0]
        else:
            def phases_of(c, p, lay=lay):
                return halo.refresh_phases(c, p, lay)
            moves = halo.refresh_moves(carries, panels, lay)
        out.append((name, carries, panels, moves, phases_of))
        if name == "refresh tight K=5":
            # the same refresh split: its y strips (rows of K floats) alone,
            # the rest (x strips, corners, panels) alone, and one float (the
            # launch's floor)
            def is_y(move, lay=lay):
                index = move[0].index
                return (len(index) == 3 and index[1].stop - index[1].start == lay.lx
                        and index[2].stop - index[2].start == lay.depth)

            for part, want_y in (("y strips", True), ("x strips, corners, panels", False)):
                def part_phases(c, p, lay=lay, want_y=want_y, is_y=is_y):
                    return [[m for m in halo.refresh_moves(c, p, lay) if is_y(m) == want_y]]
                out.append((f"{name}: {part}", carries, panels,
                            part_phases(carries, panels)[0], part_phases))
            one = [(halo.Strip(carries, (0, 0), (0, slice(0, 1), slice(0, 1))),
                    halo.Strip(carries, (0, 0), (0, slice(K, K + 1), slice(K, K + 1))))]
            out.append(("one float", carries, panels, one,
                        lambda c, p: [[(halo.Strip(c, *one[0][0][1:]),
                                        halo.Strip(c, *one[0][1][1:]))]]))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="output/exchange_variants.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_exchange_variants: no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = chip_smoke.nvidia_smi_line()
    print(f"  device: {smi}", flush=True)
    stream = torch.cuda.current_stream(device).cuda_stream
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    readings = {"device": smi, "variants": {k: list(v) for k, v in VARIANTS.items()}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for name, carries, panels, moves, phases_of in cases(device):
            want = [None if b is None else tuple(tuple(t.clone() for t in col) for col in b)
                    for b in (carries, panels)]
            for phase in phases_of(*want):
                halo.copy_pairs(halo.move_pairs(phase))
            calls, vector_min = {}, halo_rdma.VECTOR_MIN
            for variant, (threads, items, blocks, vmin) in VARIANTS.items():
                halo_rdma.VECTOR_MIN = vmin
                rows = halo_rdma.rect_rows(halo.move_pairs(moves))
                table = torch.tensor(rows, dtype=torch.int64, device=device)
                lib = libs[(threads, items, blocks)]

                def launch(lib=lib, table=table, rows=rows):
                    err = lib.lbm_halo_exchange(table.data_ptr(), len(rows),
                                                halo_rdma.n_slots(rows), device.index, sms,
                                                stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed: error {err}")

                calls[variant] = (launch, table)
                launch()
                torch.cuda.synchronize()
                for got, ref in zip((carries, panels), want):
                    if ref is not None:
                        for col_g, col_r in zip(got, ref):
                            for g, r in zip(col_g, col_r):
                                if not torch.equal(g.view(torch.int32), r.view(torch.int32)):
                                    raise AssertionError(f"{variant} differs on {name}")
            halo_rdma.VECTOR_MIN = vector_min
            ms = {variant: [] for variant in VARIANTS}
            for variant in list(VARIANTS) + list(VARIANTS)[::-1]:
                ms[variant].append(chip_smoke.busy_time(calls[variant][0], REPS)[0])
            bytes_moved = 2 * sum(src.numel() * 4 for _, src in halo.move_pairs(moves))
            bound = bytes_moved / chip_smoke.PEAK_BYTES_PER_S * 1e3
            readings[name] = {"ms": ms, "bound_ms": bound, "rects": len(moves)}
            for variant, values in ms.items():
                mean = sum(values) / len(values)
                print(f"  {N}^2 mesh {MESH} {name}, {variant} {VARIANTS[variant]}: "
                      f"{values} ms, mean {mean:.5f} ms ({mean / bound:.2f}x the bound "
                      f"{bound:.5f} ms)", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(readings, indent=1))
    print(f"  readings written to {out}", flush=True)


if __name__ == "__main__":
    main()
