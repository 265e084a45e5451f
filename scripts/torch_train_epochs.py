#!/usr/bin/env python
"""Seconds an epoch of each training job of ``scripts/torch_pipeline_cards.py``
(the keys of its ``EPOCHS``) on the card, and over several cards of one
process as ``ml.train(mesh=)`` trains them.

Each key is a model at its grid and batch on the 500-cavity dataset less
``train_full``'s seven held-out Re (394 training cavities, 99 validating),
Adam, TF32 off: ``steps`` training steps (``train.loss_and_grads`` over the
replicas, the Adam update, the parameters copied back to the replicas, one
minibatch indexed out of a batch held on the first card) and one
validation forward, timed by the wall clock after an untimed step, the
cards synchronised at both ends: ``BLOCKS`` blocks of ``REPS`` steps and a
forward each, the fastest block's step and forward read (a small model's
step is bound by the host's launches, and other load on a shared host
only slows a block).
The dataset is random, one batch made in the call (the validation set its
cavities repeated): the time of a step does not depend on the values.

Usage (from the repository root):

    python scripts/torch_train_epochs.py [--keys cnn_nine] [--cards 2]

prints, per key, the epoch on one card and on ``--cards`` cards (default:
every visible card) with the speed-up, then one JSON line.  Over several
cards it also holds a few steps to the same steps on one card (each step's
loss, the first step's gradients) and exits 1 where they differ by more
than float reduction order.  ``--device cpu`` times on the CPU
(``--cards`` then counts CPU entries).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np
import torch

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(SCRIPTS)
sys.path.insert(0, ROOT)
sys.path.insert(0, SCRIPTS)

from latticeboltzmannsimulations_torch.ml import datagen, models, train  # noqa: E402
from torch_diagnose_cnn_eight import register_variants  # noqa: E402
from torch_pipeline_cards import EPOCHS, TPU_PRECISION  # noqa: E402
from torch_train_full import precision  # noqa: E402

CAVITIES = 500 - 7
# the runner's one-card keys: the preset and its grid
MODELS = {key: (preset, n) for key, (preset, n, _) in EPOCHS.items() if "@" not in key}
REPS = 5
BLOCKS = 7
# steps of several cards held to one card's, and the tolerance
HOLD_STEPS = 5
HOLD_RTOL, HOLD_ATOL = 1e-4, 1e-5


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _case(key: str, devices, seed: int, init: dict | None = None):
    """``key``'s model (its replicas over ``devices``, from ``init`` where
    given), its Adam, one random batch on the first device, the validation
    set and the step; the step's loss is returned on the first device."""
    register_variants()
    name, n = MODELS[key]
    preset = dataclasses.replace(models.PRESETS[name], optimizer="adam")
    b = preset.batch_size
    devices = [torch.device(d) for d in devices]
    rng = np.random.default_rng(seed)
    ds = datagen.DatasetArrays(
        re_range=np.linspace(100.0, 5090.0, b),
        feq_initial=rng.random((9, n, n), dtype=np.float32),
        f_final=rng.random((b, 9, n, n), dtype=np.float32),
        u_final=(0.1 * rng.standard_normal((b, 2, n, n))).astype(np.float32))
    data = train.prepare_inputs(ds, preset)
    first = devices[0]
    x, aux, y = (None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(first)
                 for a in (data.fnet, data.aux, data.targets["x"]))
    model = models.make_model(name, seed=seed)
    if init is not None:
        model.load_state_dict(init)
    model = model.to(first)
    replicas = [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]
    opt = train.Optimizer(preset, model.parameters(), 1e-3)
    order = torch.arange(b, device=first)

    def step():
        loss = train.loss_and_grads(replicas, x[order], None if aux is None else aux[order],
                                    y[order])
        opt.step()
        train._sync_replicas(replicas)
        return loss

    return types.SimpleNamespace(name=name, n=n, b=b, devices=devices, x=x, aux=aux, y=y,
                                 model=model, step=step)


def epoch_seconds(key: str, devices, reps: int = REPS, seed: int = 0) -> dict:
    """One epoch of ``key`` over ``devices`` (one replica each): the step's
    and the validation forward's milliseconds, each the fastest of
    ``BLOCKS`` timed blocks (``reps`` steps, one forward), and the epoch's
    seconds; a key of ``TPU_PRECISION`` with every convolution at the
    TPU's precision."""
    with precision(key in TPU_PRECISION):
        return _epoch_seconds(key, devices, reps, seed)


def _epoch_seconds(key: str, devices, reps: int, seed: int) -> dict:
    c = _case(key, devices, seed)
    tr_idx, va_idx = train.train_val_split(CAVITIES)
    va = torch.arange(len(va_idx), device=c.devices[0]) % c.b
    xv, auxv, yv = c.x[va], None if c.aux is None else c.aux[va], c.y[va]

    def validate():
        with torch.no_grad():
            return float(train._mse(c.model, xv, auxv, yv))

    c.step()
    validate()
    _sync(c.devices)
    step_ms, val_ms = [], []
    for _ in range(BLOCKS):
        t0 = time.perf_counter()
        for _ in range(reps):
            c.step()
        _sync(c.devices)
        step_ms.append((time.perf_counter() - t0) / reps * 1e3)
        t0 = time.perf_counter()
        validate()
        val_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms, val_ms = min(step_ms), min(val_ms)
    steps = len(tr_idx) // c.b
    return {"key": key, "preset": c.name, "grid": c.n, "batch": c.b, "cards": len(c.devices),
            "step_ms": round(step_ms, 3), "steps": steps, "val_ms": round(val_ms, 3),
            "epoch_s": round((steps * step_ms + val_ms) / 1e3, 4)}


def hold_to_one_card(key: str, devices, steps: int = HOLD_STEPS, seed: int = 0) -> dict:
    """``steps`` training steps of ``key`` over ``devices`` against the same
    steps on the first of them alone, from the same initial weights on the
    same batch: each step's loss within ``HOLD_RTOL``/``HOLD_ATOL`` of one
    card's, and the first step's gradients (the replicas' mean, on the first
    device) within ``HOLD_RTOL`` of each tensor's largest entry, plus
    ``HOLD_ATOL``: the minibatch's mean over the replicas in another float
    order (the tolerance of the CPU test of ``--data-parallel``)."""
    init = models.make_model(MODELS[key][0], seed=seed).state_dict()
    runs = []
    for group in (devices[:1], devices):
        c = _case(key, group, seed, init)
        losses, grads = [], None
        for i in range(steps):
            losses.append(float(c.step()))
            if i == 0:
                grads = [p.grad.detach().cpu().double() for p in c.model.parameters()]
        runs.append((losses, grads))
    (l1, g1), (lk, gk) = runs
    d_loss = max(abs(a - b) - HOLD_RTOL * abs(a) for a, b in zip(l1, lk))
    d_grad = max(float((b - a).abs().max() - HOLD_RTOL * a.abs().max())
                 for a, b in zip(g1, gk))
    return {"key": key, "cards": len(devices), "steps": steps, "loss_one": l1, "loss_many": lk,
            "max_loss_excess": d_loss, "max_grad_excess": d_grad,
            "rtol": HOLD_RTOL, "atol": HOLD_ATOL,
            "ok": d_loss <= HOLD_ATOL and d_grad <= HOLD_ATOL}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--keys", default=",".join(MODELS))
    ap.add_argument("--cards", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available (pass --device cpu for the CPU)")
        k = args.cards or torch.cuda.device_count()
        group = [f"cuda:{i}" for i in range(k)]
    else:
        k = args.cards or 1
        group = ["cpu"] * k
    rows, ok = [], True
    for key in filter(None, args.keys.split(",")):
        one = epoch_seconds(key, group[:1])
        row = {"one": one}
        if k > 1 and one["batch"] % k == 0:     # train(mesh=) splits each batch evenly
            many = epoch_seconds(key, group)
            row.update(many=many, speedup=round(one["epoch_s"] / many["epoch_s"], 4))
        rows.append(row)
        print(f"{key}: one card {one['epoch_s']} s an epoch (step {one['step_ms']} ms)"
              + (f"; {k} cards {row['many']['epoch_s']} s (step {row['many']['step_ms']} ms), "
                 f"{row['speedup']}x" if "many" in row else ""), flush=True)
        if "many" in row:
            held = row["held"] = hold_to_one_card(key, group)
            ok = ok and held["ok"]
            print(f"{key}: {k} cards against one over {held['steps']} steps: losses "
                  f"{held['loss_many']} against {held['loss_one']}; excess over "
                  f"rel {HOLD_RTOL:g}: loss {held['max_loss_excess']:.3g}, first gradients "
                  f"{held['max_grad_excess']:.3g} (abs {HOLD_ATOL:g} allowed)", flush=True)
    print(json.dumps({"epochs": rows, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
