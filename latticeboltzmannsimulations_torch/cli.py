"""Command-line interface: the JAX package's ``cli.py`` with its flags and
defaults, on the port.

    python -m latticeboltzmannsimulations_torch run --nx 256 --re 1000 --collision mrt
    python -m latticeboltzmannsimulations_torch datagen --out data/ --grid 384
    python -m latticeboltzmannsimulations_torch train --preset cnn_eight --data data/
    python -m latticeboltzmannsimulations_torch predict --preset cnn_eight --re 2500

Every subcommand runs on the card unless given ``--device cpu``; without a
card ``--device cuda`` (the default) raises.  ``--mesh MxN`` takes the first
M*N cards (raising when fewer are visible), or on ``cpu`` the CPU M*N
times.  ``run --backend`` takes the port's route names (``sim.BACKENDS``),
and ``run`` prints its summary as JSON on the last line.  ``train`` writes
``.pt`` weights (``ml.train.save_weights``), which ``predict`` loads.
``bench`` times nothing here: the port's headline benchmark is not defined
yet, and it says so and exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from .sim import BACKENDS


def _add_cfg_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--ny", type=int, default=0, help="default: nx")
    p.add_argument("--re", type=float, default=1000.0)
    p.add_argument("--u-lid", type=float, default=0.08)
    p.add_argument("--collision", choices=["srt", "trt", "mrt"], default="mrt")
    p.add_argument("--boundary", default="nebb",
                   choices=["nebb", "nebb_west_eq", "nebb_tangential",
                            "bounce_back"])
    p.add_argument("--turbulence", choices=["none", "smagorinsky"],
                   default="none")
    p.add_argument("--precision", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--max-steps", type=int, default=200_000)
    p.add_argument("--interval", type=int, default=2000)
    p.add_argument("--mesh", type=str, default="1x1",
                   help="device mesh, e.g. 2x4")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the card; cpu only when asked)")


def _mesh_shape(spec: str) -> tuple[int, int]:
    mx, my = (int(v) for v in spec.lower().split("x"))
    return mx, my


def _mesh_devices(spec: str, n_dev: int, device: str) -> list:
    """The devices of an ``n_dev``-device mesh: the first ``n_dev`` cards,
    or on ``cpu`` the CPU ``n_dev`` times.  Raises rather than build a
    smaller mesh when fewer cards are visible."""
    if device == "cpu":
        return ["cpu"] * n_dev
    avail = torch.cuda.device_count()
    if avail < n_dev:
        raise SystemExit(
            f"--mesh {spec} needs {n_dev} devices but only {avail} "
            "are visible; a smaller mesh would silently drop the requested "
            "parallelism")
    return [torch.device("cuda", i) for i in range(n_dev)]


def _cfg_from(args) -> "SimConfig":
    from .config import SimConfig

    return SimConfig(
        nx=args.nx, ny=args.ny or args.nx, reynolds=args.re,
        u_lid=args.u_lid, collision=args.collision, boundary=args.boundary,
        turbulence=args.turbulence, precision=args.precision,
        max_steps=args.max_steps, report_interval=args.interval,
        mesh_shape=_mesh_shape(args.mesh),
    ).validate()


def cmd_run(args) -> int:
    from .sim import SimOptions, simulate

    cfg = _cfg_from(args)
    mx, my = cfg.mesh_shape
    device = (args.device if mx * my == 1
              else _mesh_devices(args.mesh, mx * my, args.device))
    opts = SimOptions(
        out_dir=args.out, save_plots=args.plots, save_vtk=args.vtk,
        checkpoint_every=args.checkpoint_every, resume_from=args.resume,
        backend=args.backend, profile_dir=args.profile,
    )
    s = simulate(cfg, opts, device=device)
    print(json.dumps(dataclass_dict(s)))
    return 0


def dataclass_dict(obj) -> dict:
    return {k: (v if not isinstance(v, float) or np.isfinite(v) else None)
            for k, v in dataclasses.asdict(obj).items()}


def _parse_mesh(spec: str | None, device: str):
    """``MxN`` -> a data-parallel mesh of M*N devices along its first axis,
    ``(M*N, 1)``, or None for the 1x1 single-device default."""
    if not spec:
        return None
    n_dev = int(np.prod(_mesh_shape(spec)))
    if n_dev <= 1:
        return None
    from .parallel import make_mesh

    return make_mesh((n_dev, 1), _mesh_devices(spec, n_dev, device))


def cmd_datagen(args) -> int:
    from .config import SimConfig
    from .ml import generate_dataset, save_dataset

    cfg = SimConfig(
        nx=args.grid, ny=args.grid, reynolds=100.0, collision="srt",
        turbulence="smagorinsky" if args.smagorinsky else "none",
        max_steps=args.max_steps, report_interval=args.interval,
        precision="float32",
    ).validate()
    re_values = np.arange(args.re_start, args.re_stop, args.re_step,
                          dtype=np.float64)
    mesh = _parse_mesh(args.mesh, args.device)
    ds = generate_dataset(cfg, re_values, batch_size=args.batch,
                          progress=print, mesh=mesh, device=args.device)
    save_dataset(ds, args.out)
    print(f"saved {len(re_values)} runs to {args.out}")
    return 0


def cmd_train(args) -> int:
    from .ml import PRESETS, load_dataset
    from .ml import train as ml_train

    ds = load_dataset(args.data)
    data = ml_train.prepare_inputs(ds, PRESETS[args.preset])
    mesh = _parse_mesh(args.mesh, args.device)
    for comp in args.components.split(","):
        res = ml_train.train(
            args.preset, data, component=comp,
            epochs=args.epochs or None, batch_size=args.batch or None,
            verbose=True, mesh=mesh, device=args.device,
        )
        path = ml_train.save_weights(res, args.out, scalers=data.scalers)
        ml_train.plot_history(
            res.history, os.path.splitext(path)[0] + "_loss.png")
        print(f"saved {path}")
    return 0


def cmd_predict(args) -> int:
    from .config import SimConfig
    from .ml import PRESETS, load_dataset
    from .ml import predict as ml_predict
    from .ml import train as ml_train

    ds = load_dataset(args.data)
    preset = PRESETS[args.preset]
    data = ml_train.prepare_inputs(ds, preset)
    params_x, meta = ml_train.load_weights(args.preset, "x", args.weights)
    params_y, _ = ml_train.load_weights(args.preset, "y", args.weights)
    scalers = meta.get("scalers", data.scalers)

    fnet, aux = ml_predict.build_input(
        args.preset, args.re, ds.feq_initial, scalers)
    u_cnn = ml_predict.predict_velocity(
        args.preset, params_x, params_y, fnet, aux, scalers, device=args.device)

    nx = ds.feq_initial.shape[1]
    cfg = SimConfig(nx=nx, ny=nx, reynolds=args.re, collision="srt",
                    max_steps=args.max_steps, report_interval=2000,
                    precision="float32").validate()
    u_lbm = ml_predict.lbm_reference(cfg, device=args.device)
    metrics = ml_predict.comparison_figure(
        cfg, u_lbm, u_cnn,
        os.path.join(args.out, f"{args.preset}_predict_Re{args.re:g}.png"))
    print(json.dumps(metrics))
    return 0


def cmd_bench(args) -> int:
    print("bench: the port has no headline benchmark yet (see ROADMAP.md); "
          "nothing was timed", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="latticeboltzmannsimulations_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="lid-driven cavity simulation")
    _add_cfg_args(p)
    _add_device_arg(p)
    p.add_argument("--out", default="output")
    p.add_argument("--plots", action="store_true")
    p.add_argument("--vtk", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None)
    p.add_argument("--backend", default="auto", choices=BACKENDS)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace (trace.json) of "
                        "the first compute chunk to DIR (Perfetto, "
                        "chrome://tracing)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("datagen", help="Reynolds-sweep dataset generation")
    _add_device_arg(p)
    p.add_argument("--out", default="data")
    p.add_argument("--grid", type=int, default=384)
    p.add_argument("--re-start", type=float, default=100.0)
    p.add_argument("--re-stop", type=float, default=5100.0)
    p.add_argument("--re-step", type=float, default=10.0)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--max-steps", type=int, default=3_000_000)
    p.add_argument("--interval", type=int, default=2000)
    p.add_argument("--smagorinsky", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--mesh", default=None, metavar="MxN",
                   help="spread each batch of cavities data-parallel over "
                        "M*N devices (one stack each)")
    p.set_defaults(fn=cmd_datagen)

    p = sub.add_parser("train", help="train CNN surrogate(s)")
    _add_device_arg(p)
    p.add_argument("--preset", default="cnn_eight")
    p.add_argument("--data", default="data")
    p.add_argument("--out", default="weights")
    p.add_argument("--components", default="x,y")
    p.add_argument("--epochs", type=int, default=0, help="0 = preset default")
    p.add_argument("--batch", type=int, default=0, help="0 = preset default")
    p.add_argument("--mesh", default=None, metavar="MxN",
                   help="data-parallel training over M*N devices "
                        "(--batch must divide evenly)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict", help="surrogate inference + LBM/Ghia eval")
    _add_device_arg(p)
    p.add_argument("--preset", default="cnn_eight")
    p.add_argument("--data", default="data")
    p.add_argument("--weights", default="weights")
    p.add_argument("--re", type=float, default=2500.0)
    p.add_argument("--out", default="output")
    p.add_argument("--max-steps", type=int, default=300_000)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("bench", help="headline MLUPS benchmark (not defined "
                                     "for the port yet)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
