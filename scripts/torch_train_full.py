#!/usr/bin/env python
"""Full-parity surrogate training on the card: the port's counterpart of
``scripts/train_full.py``, with its command line, held-out split, training,
evaluation and summary.  It trains ``cnn_eight`` / ``cnn_nine`` /
``cnn_ten`` at native 384^2 on the 500-cavity dataset of
``scripts/torch_datagen_full.py`` (reference:
``CNNEight_384/CNN_Eight.py:105-161``, ``CNNNine_384/CNN_Nine.py``,
``CNNTen_384/CNN_Ten.py``), evaluates them at the held-out Reynolds
numbers against the dataset's own stored LBM fields (full-field R^2 and
relative L2), and sanity-trains one early 192^2 preset on the downsampled
data.

Held-out Re values are excluded from training and from the scalers' fit.
The card's machine has no matplotlib: the loss plots and the Ghia
dashboards are drawn only where it is installed; elsewhere a held-out Re
that the Ghia tables hold gets ``comparison_metrics``' numbers and
``"figure": null``.

The summary (``<out>/summary.json``, merged into an existing one as the
JAX script does) holds beside every number of the JAX package's record of
the same model (``docs/artifacts/ml_full/summary.json``, then
``ml_full_b/summary.json``) that number as ``jax_<key>`` and the
difference as ``d_<key>``; each model also records the seconds each
component trained (``train_s``) and its weights' seed.

Usage (from the repository root, one card visible):

    python scripts/torch_train_full.py [--models cnn_eight,cnn_nine,cnn_ten]
        [--components x,y] [--epochs-scale 1.0] [--data data/ml_full]
        [--early-preset cnn_one] [--out docs/artifacts/torch/ml_full]

``--device cpu`` trains on the CPU in its place.  Two flags are the
port's own: ``--data-parallel K`` trains each component of ``--models``
data-parallel over the first K visible cards (``ml.train(mesh=)``: the
single-device minibatch schedule, the gradients averaged onto the first
card; over K CPU entries with ``--device cpu``), and ``--evaluate-only``
trains nothing and evaluates each model's weights that earlier runs saved
in ``<out>/<model>`` (one run per component, as ``--components x`` and
``--components y`` on two groups of cards, then this).  Both the trained
and the evaluated weights are read back from disk for the evaluation
(``evaluate_saved``), so it is the same either way.

A run that evaluates a model also keeps what it scored against,
``<out>/held_out_truth.npz`` (``save_truth``: the held-out LBM fields, the
lid speed, each evaluated model's scalers, and ``feq_initial`` only where
the configuration does not rebuild it exactly), so that saved weights can
be scored later without the dataset (``scripts/torch_score_weights.py``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import types
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from latticeboltzmannsimulations_torch import engine  # noqa: E402
from latticeboltzmannsimulations_torch.config import SimConfig  # noqa: E402
from latticeboltzmannsimulations_torch.ml import datagen, predict, train as tr  # noqa: E402
from latticeboltzmannsimulations_torch.ml.models import PRESETS  # noqa: E402
from latticeboltzmannsimulations_torch.parallel.mesh import make_mesh  # noqa: E402
from latticeboltzmannsimulations_torch.validate.ghia_data import has_reynolds  # noqa: E402

HELD_OUT = [500.0, 1500.0, 2500.0, 3200.0, 4500.0, 5000.0, 5050.0]
# the JAX package's records of these runs, searched in order for a model
JAX_RECORDS = [os.path.join(ROOT, "docs", "artifacts", d, "summary.json")
               for d in ("ml_full", "ml_full_b")]
SEED = 0                   # train's default: every model's initial weights
# The kept record of what the evaluation scores against, written beside the
# summary (``save_truth``)
TRUTH = "held_out_truth.npz"


def full_field_r2(u_true: np.ndarray, u_pred: np.ndarray) -> float:
    ss_res = float(((u_true - u_pred) ** 2).sum())
    ss_tot = float(((u_true - u_true.mean()) ** 2).sum())
    return 1.0 - ss_res / (ss_tot + 1e-30)


def split_dataset(ds, held_out):
    mask = ~np.isin(ds.re_range, held_out)
    train_ds = datagen.DatasetArrays(
        re_range=ds.re_range[mask], feq_initial=ds.feq_initial,
        f_final=ds.f_final[mask], u_final=ds.u_final[mask],
        # carry the quarantine mask so prepare_inputs' drop_failed still
        # sees it after the held-out split (zero-filled diverged slots must
        # never train) ...
        failed=None if ds.failed is None else ds.failed[mask],
    )
    # ... and never evaluate against a quarantined (zero-filled) "truth".
    held = {float(r): ds.u_final[i]
            for i, r in enumerate(ds.re_range)
            if float(r) in held_out
            and (ds.failed is None or not ds.failed[i])}
    return train_ds, held


class Truth(NamedTuple):
    """A kept held-out record (``load_truth``): what ``evaluate`` reads of the
    dataset, and the scalers of each model the run evaluated."""
    held: dict                 # Re -> LBM u (2, X, Y)
    feq_initial: np.ndarray    # (9, X, Y)
    u_lid: float
    scalers: dict              # model -> its scalers, as its sidecar holds them


def initial_feq(grid: int, u_lid: float) -> np.ndarray:
    """The sweep's ``feq_initial`` at ``grid``^2: the initial equilibrium of
    its float32 cavity (``engine.init_state``), built on the CPU."""
    cfg = SimConfig(nx=grid, ny=grid, u_lid=u_lid, precision="float32")
    return engine.init_state(cfg, "cpu").f.numpy()


def save_truth(path, held, feq_initial, u_lid, scalers) -> None:
    """One compressed record of the held-out LBM fields (float32, by Re),
    ``u_lid`` and ``scalers`` (model -> scalers); ``feq_initial`` is stored
    only where ``initial_feq`` does not rebuild it bit for bit."""
    res = sorted(held)
    arrays = {"re": np.asarray(res, np.float64),
              "u_final": np.stack([held[r] for r in res]).astype(np.float32),
              "u_lid": np.float64(u_lid), "scalers": np.array(json.dumps(scalers))}
    if not np.array_equal(feq_initial, initial_feq(feq_initial.shape[-1], u_lid)):
        arrays["feq_initial"] = feq_initial
    np.savez_compressed(path, **arrays)


def load_truth(path) -> Truth:
    """``save_truth``'s record, ``feq_initial`` rebuilt where it was not stored."""
    with np.load(path) as z:
        u, u_lid = z["u_final"], float(z["u_lid"])
        feq = z["feq_initial"] if "feq_initial" in z.files else initial_feq(u.shape[-1], u_lid)
        return Truth({float(r): u[i] for i, r in enumerate(z["re"])}, feq, u_lid,
                     json.loads(str(z["scalers"])))


def downsample(ds, k=2):
    return datagen.DatasetArrays(
        re_range=ds.re_range, feq_initial=ds.feq_initial[:, ::k, ::k],
        f_final=ds.f_final[:, :, ::k, ::k], u_final=ds.u_final[:, :, ::k, ::k],
        failed=ds.failed,
    )


def figures() -> bool:
    """Whether matplotlib is installed (the card's machine has none)."""
    return importlib.util.find_spec("matplotlib") is not None


def train_model(name, data, components, epochs_scale, out_dir, log,
                optimizer=None, lr=1e-3, schedule=None, device="cuda", mesh=None):
    """Train and save each component; returns the seconds each trained."""
    preset = PRESETS[name]
    seconds = {}
    for comp in components:
        epochs = max(1, int(round(preset.epochs * epochs_scale)))
        t0 = time.time()
        res = tr.train(name, data, component=comp, epochs=epochs,
                       verbose=False, optimizer=optimizer,
                       learning_rate=lr, schedule=schedule, device=device, mesh=mesh)
        dt = time.time() - t0
        tr.save_weights(res, out_dir, scalers=data.scalers)
        if figures():
            tr.plot_history(res.history,
                            os.path.join(out_dir, f"{name}_{comp}_loss.png"))
        log(f"{name}/{comp}: {epochs} epochs in {dt:.0f}s, "
            f"final val MSE {res.history['val_loss'][-1]:.3e}")
        seconds[comp] = round(dt, 2)
    return seconds


class Saved(NamedTuple):
    """A component as ``save_weights`` wrote it: what ``evaluate`` reads of
    ``train``'s result."""
    params: dict
    history: dict


def evaluate_saved(name, components, data, ds, held, u_lid, out_dir, log, lr=1e-3,
                   schedule=None, device="cuda"):
    """The held-out evaluation of ``name``'s components saved in ``out_dir``
    (each ``<name>_<c>.pt`` or ``.msgpack`` and its sidecar's history) and
    the model's summary entry as ``train_full`` writes it; returns
    ``(results, entry)``.  A y half alone is not evaluated: the evaluation
    predicts with x (and with x in y's place where y is missing)."""
    results = {}
    for comp in components:
        params, meta = tr.load_weights(name, comp, out_dir)
        results[comp] = Saved(params, meta["history"])
    recs = (evaluate(name, results, data, ds, held, u_lid, out_dir, log, device)
            if "x" in results else [])
    entry = {
        "epochs": {c: len(results[c].history["loss"]) for c in results},
        "lr": lr, "schedule": schedule or "constant",
        "final_val_mse": {c: results[c].history["val_loss"][-1] for c in results},
        "held_out_eval": recs,
    }
    return results, entry


def score_saved(name, weights_dir, truth: Truth, log, device="cuda") -> dict:
    """``name``'s two halves saved in ``weights_dir`` (the port's ``.pt`` or
    the JAX package's ``.msgpack``) evaluated against a kept ``truth``
    with the scalers of their own x sidecar, which their training fitted;
    returns the entry: those scalers, the ones the truth's dataset gives
    the model (where the record holds them) and the held-out rows.  No
    figures are drawn."""
    results, scalers = {}, None
    for comp in ("x", "y"):
        params, meta = tr.load_weights(name, comp, weights_dir)
        results[comp] = Saved(params, meta.get("history"))
        scalers = scalers or meta["scalers"]
    recs = evaluate(name, results, types.SimpleNamespace(scalers=scalers), truth, truth.held,
                    truth.u_lid, None, log, device)
    return {"scalers": scalers, "dataset_scalers": truth.scalers.get(name),
            "held_out_eval": recs}


def model_record(name, entry, **extra) -> dict:
    """``entry`` with JAX's record of ``name`` beside each number, then
    ``extra`` (the seconds trained, the seed, the device, ...)."""
    return dict(beside(entry, jax_record(name)), **extra)


def merge_summary(out_root, name=None, record=None, **top) -> None:
    """``record`` merged into ``<out_root>/summary.json`` as model ``name``
    (none without a name) and ``top``'s keys at its top level, as
    consecutive runs of the JAX script accumulate there."""
    path = os.path.join(out_root, "summary.json")
    summary = json.load(open(path)) if os.path.exists(path) else {"models": {}}
    summary.update(top)
    models = summary.setdefault("models", {})
    if name is not None:
        models[name] = record
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=1)


def evaluate(name, results, data, ds, held, u_lid, out_dir, log, device="cuda"):
    """Held-out-Re evaluation vs stored LBM truth (+ Ghia dashboards in
    ``out_dir`` where matplotlib is and ``out_dir`` is not None, the Ghia
    numbers everywhere).  Of ``ds`` (the dataset, or a kept ``Truth``) only
    ``feq_initial`` is read, of ``data`` only ``scalers``."""
    recs = []
    px = results["x"].params
    py = results["y"].params if "y" in results else results["x"].params
    g = ds.feq_initial.shape[-1]
    for re in sorted(held):
        fnet, aux = predict.build_input(name, re, ds.feq_initial,
                                        data.scalers, u_lid=u_lid)
        u_cnn = predict.predict_velocity(name, px, py, fnet, aux, data.scalers,
                                         device=device)
        u_lbm = held[re]
        rec = {
            "re": re,
            "r2_ux": round(full_field_r2(u_lbm[0], u_cnn[0]), 5),
            "rel_l2": round(float(np.linalg.norm(u_cnn - u_lbm)
                                  / np.linalg.norm(u_lbm)), 5),
        }
        if "y" in results:
            rec["r2_uy"] = round(full_field_r2(u_lbm[1], u_cnn[1]), 5)
            if has_reynolds(re):
                cfg = SimConfig(nx=g, ny=g, reynolds=re, collision="srt",
                                turbulence="smagorinsky",
                                precision="float32")
                if out_dir is not None and figures():
                    fig = predict.comparison_figure(
                        cfg, u_lbm, u_cnn,
                        os.path.join(out_dir, f"{name}_re{re:g}_compare.png"))
                else:
                    fig = predict.comparison_metrics(cfg, u_lbm, u_cnn)
                    fig["figure"] = None
                    fig["cnn_vs_lbm_l2"] = fig.pop("cnn_vs_lbm_l2")   # JAX's key order
                rec.update({k: (round(v, 5) if isinstance(v, float) else v)
                            for k, v in fig.items()})
        recs.append(rec)
        log(f"{name} Re={re:g}: R2(ux)={rec['r2_ux']:.4f} "
            f"relL2={rec['rel_l2']:.4f}")
    return recs


def jax_record(name: str):
    """The JAX package's summary entry of ``name``, or None."""
    for path in JAX_RECORDS:
        if os.path.exists(path):
            with open(path) as fh:
                models = json.load(fh).get("models", {})
            if name in models:
                return models[name]
    return None


def beside(port, jax):
    """``port`` with the JAX record's number beside each of its numbers
    (``jax_<key>``) and the difference (``d_<key>``), recursively; the
    held-out lists matched by Re."""
    if isinstance(port, dict) and isinstance(jax, dict):
        out = {}
        for key, value in port.items():
            out[key] = beside(value, jax.get(key))
            ref = jax.get(key)
            if (isinstance(value, (int, float)) and isinstance(ref, (int, float))
                    and not isinstance(value, bool) and key != "re"):
                out[f"jax_{key}"] = ref
                out[f"d_{key}"] = value - ref
        return out
    if isinstance(port, list) and isinstance(jax, list) and all(
            isinstance(r, dict) and "re" in r for r in port + jax):
        by_re = {r["re"]: r for r in jax}
        return [beside(r, by_re.get(r["re"])) for r in port]
    return port


def hold_close(got, want, rtol: float, atol: float, path: str = "summary") -> float:
    """Hold ``got`` (another run's summary, or part of one) to ``want``:
    every key of ``want`` with its value, numbers that are not whole within
    ``max(atol, rtol |want|)``, figures by file name, the rest equal.  Raises
    an AssertionError naming the first value that is not; returns the
    largest difference of a number."""
    if isinstance(want, dict):
        return max([hold_close(got[k], v, rtol, atol, f"{path}.{k}")
                    for k, v in want.items()], default=0.0)
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} entries against {len(want)}")
        return max([hold_close(g, w, rtol, atol, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))], default=0.0)
    if isinstance(want, float) and not want.is_integer():
        d = abs(got - want)
        if not d <= max(atol, rtol * abs(want)):
            raise AssertionError(f"{path}: {got} against {want}")
        return d
    if isinstance(want, str) and want.endswith(".png"):
        got = os.path.basename(got) if isinstance(got, str) else got
        want = os.path.basename(want)
    if got != want:
        raise AssertionError(f"{path}: {got!r} against {want!r}")
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="cnn_eight,cnn_nine,cnn_ten")
    ap.add_argument("--components", default="x,y")
    ap.add_argument("--epochs-scale", type=float, default=1.0)
    ap.add_argument("--data", default=None)
    ap.add_argument("--early-preset", default="cnn_one",
                    help="'' disables the 192² sanity training")
    ap.add_argument("--early-epochs", type=int, default=100)
    ap.add_argument("--fine-tune-epochs", type=int, default=30,
                    help="0 disables the CNN_test-parity fine-tune pass")
    ap.add_argument("--optimizer", default="adam",
                    help="override every preset's optimizer (TPU 384²: "
                         "RMSprop plateaus at the mean predictor; see "
                         "ml/train.py). '' keeps per-preset choices.")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="",
                    help="optional LR schedule: cosine | plateau")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="train each component of --models over the first K visible "
                         "cards (K CPU entries with --device cpu)")
    ap.add_argument("--evaluate-only", action="store_true",
                    help="train nothing: evaluate each model's --components saved in "
                         "<out>/<model> by earlier runs")
    args = ap.parse_args(argv)
    device = args.device
    k = args.data_parallel
    mesh = None if k == 1 else make_mesh((k, 1), None if device == "cuda" else [device] * k)

    data_dir = args.data or os.path.join(ROOT, "data", "ml_full")
    out_root = args.out or os.path.join(ROOT, "docs", "artifacts", "torch", "ml_full")
    os.makedirs(out_root, exist_ok=True)
    t_start = time.time()

    def log(msg):
        print(f"[{time.time() - t_start:8.1f}s] {msg}", flush=True)

    ds = datagen.load_dataset(data_dir)
    meta_path = os.path.join(data_dir, "metadata.json")
    meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}
    u_lid = meta.get("u_lid", 0.08)
    log(f"dataset: {ds.f_final.shape} from {data_dir}")
    train_ds, held = split_dataset(ds, HELD_OUT)
    log(f"training on {len(train_ds.re_range)} cavities, "
        f"{len(held)} held out: {sorted(held)}")

    components = [c for c in args.components.split(",") if c]
    # Merge into an existing summary so per-model invocations (e.g. with
    # different --lr/--schedule) accumulate instead of clobbering.
    top = {"held_out": sorted(held), "dataset": meta, "epochs_scale": args.epochs_scale}
    evaluated = {}                  # model -> the scalers its evaluation used

    for name in [m for m in args.models.split(",") if m]:
        out_dir = os.path.join(out_root, name)
        os.makedirs(out_dir, exist_ok=True)
        data = tr.prepare_inputs(train_ds, PRESETS[name], u_lid=u_lid)
        seconds = {} if args.evaluate_only else train_model(
            name, data, components, args.epochs_scale, out_dir, log,
            optimizer=args.optimizer or None, lr=args.lr,
            schedule=args.schedule or None, device=device, mesh=mesh)
        results, entry = evaluate_saved(name, components, data, ds, held, u_lid, out_dir,
                                        log, args.lr, args.schedule or None, device)
        if entry["held_out_eval"]:
            evaluated[name] = data.scalers
        if args.fine_tune_epochs and name == "cnn_eight" and not args.evaluate_only:
            # CNN_test parity at native scale: reload the saved weights and
            # refit at RMSprop lr=1e-4 (reference: CNN_test.py:100-106).
            ft = {}
            for comp in components:
                res = tr.fine_tune(name, data, results[comp].params,
                                   component=comp,
                                   epochs=args.fine_tune_epochs,
                                   optimizer=args.optimizer or None,
                                   device=device)
                ft[comp] = res
                log(f"{name}/{comp} fine-tune: val MSE "
                    f"{results[comp].history['val_loss'][-1]:.3e} -> "
                    f"{res.history['val_loss'][-1]:.3e}")
                tr.save_weights(res, os.path.join(out_dir, "fine_tuned"),
                                scalers=data.scalers)
            ft_recs = evaluate(name, ft, data, ds, held, u_lid,
                               os.path.join(out_dir, "fine_tuned"), log, device)
            entry["fine_tuned"] = {
                "epochs": args.fine_tune_epochs,
                "final_val_mse": {c: ft[c].history["val_loss"][-1]
                                  for c in ft},
                "held_out_eval": ft_recs,
            }
        merge_summary(out_root, name, model_record(name, entry, train_s=seconds, seed=SEED,
                                                   device=device, data_parallel=k), **top)

    if args.early_preset and not args.evaluate_only:
        # One early-generation 192² preset, sanity-trained on the
        # downsampled dataset: shows the M1-M7 family trains, not just
        # forward-shapes (VERDICT r1 missing #3).
        name = args.early_preset
        out_dir = os.path.join(out_root, name + "_192")
        os.makedirs(out_dir, exist_ok=True)
        ds192 = downsample(train_ds, 2)
        data = tr.prepare_inputs(ds192, PRESETS[name], u_lid=u_lid)
        t0 = time.time()
        res = tr.train(name, data, component="x", epochs=args.early_epochs,
                       optimizer=args.optimizer or None, device=device)
        train_s = round(time.time() - t0, 2)
        tr.save_weights(res, out_dir, scalers=data.scalers)
        if figures():
            tr.plot_history(res.history,
                            os.path.join(out_dir, f"{name}_x_loss.png"))
        h = res.history
        entry = {
            "epochs": args.early_epochs,
            "first_loss": h["loss"][0], "final_loss": h["loss"][-1],
            "final_val_mse": {"x": h["val_loss"][-1]},
        }
        merge_summary(out_root, name + "_192",
                      model_record(name + "_192", entry, train_s={"x": train_s}, seed=SEED,
                                   device=device), **top)
        log(f"{name}@192: loss {h['loss'][0]:.3e} -> {h['loss'][-1]:.3e}")

    if evaluated:
        save_truth(os.path.join(out_root, TRUTH), held, ds.feq_initial, u_lid, evaluated)
        log(f"held-out truth -> {out_root}/{TRUTH}")
    merge_summary(out_root, **top)
    log(f"done -> {out_root}/summary.json")
    return 0

if __name__ == "__main__":
    sys.exit(main())
