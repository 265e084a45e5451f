"""Surrogate training: the JAX package's ``ml/train.py`` in PyTorch (the
reference's Keras pipeline, common structure of ``CNN_*.py``: load .npy ->
scale -> fnet assembly -> 80/20 split -> per-component model -> RMSprop/Adam
+ MSE -> save weights + loss-history plot; fine-tuning = ``CNN_test.py``).

The update gives optax's numbers, not torch's defaults: ``RMSprop`` is
``optax.rmsprop`` (decay 0.9, eps inside the root, no momentum), Adam is
``torch.optim.Adam`` with optax's betas and eps (the same arithmetic),
global-norm clipping is ``optax.clip_by_global_norm``'s rule, and each
learning-rate schedule is evaluated at the count of updates already applied.
The data stays on the device between steps; the minibatch order is the JAX
package's, draw for draw, from NumPy's generator.

Training checkpoints and weight files are written in this package's own
format (a ``torch.save`` blob; a checkpoint behind a JSON header as the JAX
package writes it).  The JAX package's flax-msgpack files are read too,
through ``flax_msgpack`` (no flax needed): ``load_weights`` takes a
``.msgpack`` weight file where no ``.pt`` is, and a JAX training checkpoint
of the same recipe resumes here, its parameters, optax state, epoch and
history carried across.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..parallel.mesh import Mesh
from . import flax_init, flax_msgpack
from .datagen import DatasetArrays, drop_failed
from .models import (PRESETS, CavityCNN, CNNPreset, _cudnn_tf32, check_grid, make_model,
                     state_dict_from_flax)
from .scaling import MaxScaler, MinMaxScaler


# ---------------------------------------------------------------------------
# Input assembly (reference: CNNEight_384/CNN_Eight.py:19-99)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PreparedData:
    fnet: np.ndarray          # (N, H, W, 10) scaled feq planes + Re plane
    aux: Optional[np.ndarray]  # (N, H, W, 2) lid-BC velocity planes or None
    targets: Dict[str, np.ndarray]  # component -> (N, H, W, 1) scaled
    scalers: Dict[str, dict]  # serializable scaler state
    u_lid: float


def _make_scalers(preset: CNNPreset):
    if preset.scaling == "max":
        return {k: MaxScaler() for k in ("re", "feq", "vel")}
    rng = preset.scale_range
    if preset.scaling == "minmax":
        return {"re": MinMaxScaler(rng), "feq": None, "vel": None}
    if preset.scaling == "minmax_all":
        return {k: MinMaxScaler(rng) for k in ("re", "feq", "vel")}
    raise ValueError(preset.scaling)


def prepare_inputs(ds: DatasetArrays, preset: CNNPreset,
                   u_lid: float = 0.08) -> PreparedData:
    """Scale and assemble the network inputs.

    fnet = concat(feq_initial broadcast over runs [9ch], Re plane [1ch]);
    aux = lid-row velocity planes velBCx/velBCy (zero except the lid row)
    (reference: ``CNN_Eight.py:23-25,86-91``).

    Quarantined (diverged, zero-filled) cavities are dropped here so they
    can never reach training regardless of how the dataset was assembled.
    """
    ds = drop_failed(ds)
    n = len(ds.re_range)
    scalers = _make_scalers(preset)

    feq = np.transpose(ds.feq_initial, (1, 2, 0))       # (H, W, 9)
    if scalers["feq"] is not None:
        feq = scalers["feq"].fit_transform(feq)
    re_scaled = scalers["re"].fit_transform(
        np.asarray(ds.re_range, np.float64)
    ).astype(np.float32)

    h, w = feq.shape[:2]
    fnet = np.empty((n, h, w, 10), np.float32)
    fnet[..., :9] = feq[None]
    fnet[..., 9] = re_scaled[:, None, None]

    vel = np.transpose(ds.u_final, (0, 2, 3, 1))        # (N, H, W, 2)
    if scalers["vel"] is not None:
        vel = scalers["vel"].fit_transform(vel)
    targets = {"x": vel[..., :1], "y": vel[..., 1:2]}

    aux = None
    if preset.aux_bc_at_input or preset.aux_bc_at_head:
        bc = np.zeros((h, w, 2), np.float32)
        bc[:, 0, 0] = u_lid  # lid row (y index 0), x-velocity
        if scalers["vel"] is not None:
            bc = scalers["vel"].transform(bc)
        aux = np.broadcast_to(bc, (n, h, w, 2)).copy()

    return PreparedData(
        fnet=fnet, aux=aux, targets=targets,
        scalers={k: (s.to_dict() if s is not None else None)
                 for k, s in scalers.items()},
        u_lid=u_lid,
    )


def train_val_split(n: int, val_frac: float = 0.2, seed: int = 4):
    """Deterministic shuffle split (reference: train_test_split
    ``random_state=4``, ``CNN_Eight.py:98``)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_val = max(1, int(round(n * val_frac)))
    return perm[n_val:], perm[:n_val]


# ---------------------------------------------------------------------------
# The optimiser layer: optax's arithmetic
# ---------------------------------------------------------------------------

class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``'s defaults: ``nu = (1 - decay) g^2 + decay nu`` and
    ``p -= lr * g / sqrt(nu + eps)``, decay 0.9, eps 1e-8 inside the root,
    no momentum and no bias correction.  ``torch.optim.RMSprop`` differs in
    both constants' places (alpha 0.99, eps outside the root): its first
    update is ``+-10 lr`` for every nonzero g, optax's ``+-sqrt(10) lr`` for
    ``|g|`` well above 3e-4 and linear in g below it."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = (1 - decay) * (g * g) + decay * state["nu"]
                state["nu"] = nu
                p.add_(-lr * (torch.rsqrt(nu + eps) * g))


def lr_schedule(learning_rate: float, schedule: Optional[str] = None,
                total_steps: int = 0) -> Callable[[int], float]:
    """The learning rate as a function of the count of updates already
    applied (0 for the first), as the JAX package's optax schedules give it:
    None (constant); 'cosine' (decay to lr/100 over ``max(1, total_steps)``,
    ``optax.cosine_decay_schedule(alpha=0.01)``); 'plateau' (x0.2 from
    ``int(0.5 T)`` and again from ``int(0.8 T)``, one boundary when the two
    coincide, ``optax.piecewise_constant_schedule``); 'inverse' or
    'inverse:<rate>' (Keras-style ``lr / (1 + rate * count)``, rate 0.02 by
    default; ``CNN_test.py`` retrains use 'inverse:0.04')."""
    lr = learning_rate
    if schedule is None:
        return lambda count: lr
    if schedule == "cosine":
        t = max(1, total_steps)

        def cosine(count: int) -> float:
            decay = 0.5 * (1 + math.cos(math.pi * min(count, t) / t))
            return lr * ((1 - 0.01) * decay + 0.01)

        return cosine
    if schedule == "plateau":
        # a dict, as the JAX package's: equal boundaries collapse to one
        bounds = sorted({int(total_steps * 0.5): 0.2, int(total_steps * 0.8): 0.2}.items())

        def plateau(count: int) -> float:
            v = lr
            for threshold, scale in bounds:
                if count >= threshold:
                    v = scale * v
            return v

        return plateau
    if schedule == "inverse" or schedule.startswith("inverse:"):
        rate = float(schedule.split(":", 1)[1]) if ":" in schedule else 0.02
        lr0 = float(lr)
        return lambda count: lr0 / (1.0 + rate * count)
    raise ValueError(f"unknown lr schedule {schedule!r}")


def clip_by_global_norm(params: Sequence[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` on the gradients of ``params``, in
    place: left as they are when their global norm is below ``max_norm``,
    else ``g / norm * max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides
    by ``norm + 1e-6``).  Decided on the device, without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


class Optimizer:
    """The JAX package's ``_optimizer``: optional global-norm clipping, then
    the preset's optimiser (``adam`` or ``rmsprop``) at the schedule's rate
    for ``count``, the updates applied so far."""

    def __init__(self, preset: CNNPreset, params, learning_rate: float,
                 schedule: Optional[str] = None, total_steps: int = 0,
                 clip_norm: Optional[float] = None):
        self.params = list(params)
        self.lr_at = lr_schedule(learning_rate, schedule, total_steps)
        self.clip_norm = clip_norm
        self.count = 0
        lr0 = self.lr_at(0)
        if preset.optimizer == "adam":
            # optax.adam: b1 0.9, b2 0.999, eps 1e-8 outside the root,
            # eps_root 0 -- torch's Adam arithmetic with these constants
            self.opt = torch.optim.Adam(self.params, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
        else:
            self.opt = RMSprop(self.params, lr=lr0)

    def step(self) -> None:
        """One update from the gradients in ``params``' ``.grad``."""
        if self.clip_norm is not None:
            clip_by_global_norm(self.params, self.clip_norm)
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.opt.step()
        self.count += 1


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainResult:
    params: dict            # the model's state_dict, on the CPU
    history: dict           # {"loss": [...], "val_loss": [...]}
    preset: CNNPreset
    component: str


def _mse(model: CavityCNN, xb, auxb, yb) -> torch.Tensor:
    pred = model(xb) if auxb is None else model(xb, auxb)
    return torch.mean((pred - yb) ** 2)


def _replica_devices(mesh: Mesh, batch_size: int) -> List[torch.device]:
    """The devices of the mesh's first axis, one replica each."""
    if mesh.spans_processes:
        raise NotImplementedError(
            "train(mesh=...) runs in one process; training over a "
            "torch.distributed group is not ported yet (ROADMAP.md queue 1)")
    dp = mesh.shape[0]
    if batch_size % dp:
        raise ValueError(
            f"data-parallel batch_size {batch_size} must divide over "
            f"the mesh's first axis ({dp} devices)")
    return [mesh.device(ix, 0) for ix in range(dp)]


def loss_and_grads(replicas: Sequence[CavityCNN], xb, auxb, yb) -> torch.Tensor:
    """The minibatch's mean squared error, its gradients left in
    ``replicas[0]``'s ``.grad``: on one model, or split in equal slices over
    the replicas (each on its own device, its loss the mean over its slice),
    the loss and gradients the mean over them, reduced onto the first
    replica's device.  The backward runs under the models' TF32 switch, as
    their forward does (cuDNN's global default would take TF32)."""
    main = replicas[0]
    with _cudnn_tf32(main.allow_tf32):
        if len(replicas) == 1:
            main.zero_grad(set_to_none=True)
            loss = _mse(main, xb, auxb, yb)
            loss.backward()
            return loss.detach()
        # Every replica's slice is copied out before any replica computes: a
        # copy between cards runs on the first card's stream behind a barrier
        # on both, so a slice copied after the first replica's backward would
        # hold the other cards until that backward had run.
        m = len(xb) // len(replicas)
        parts = []
        for r, model in enumerate(replicas):
            d = next(model.parameters()).device
            part = slice(r * m, (r + 1) * m)
            parts.append((xb[part].to(d), None if auxb is None else auxb[part].to(d),
                          yb[part].to(d)))
        losses = []
        for model, part in zip(replicas, parts):
            model.zero_grad(set_to_none=True)
            loss = _mse(model, *part)
            loss.backward()
            losses.append(loss.detach())
    first = next(main.parameters()).device
    with torch.no_grad():
        for p, *others in zip(main.parameters(), *(r.parameters() for r in replicas[1:])):
            p.grad = torch.stack([p.grad, *(q.grad.to(first) for q in others)]).mean(0)
        return torch.stack([loss.to(first) for loss in losses]).mean()


def _sync_replicas(replicas: Sequence[CavityCNN]) -> None:
    """Copy the first replica's parameters to the others."""
    with torch.no_grad():
        for model in replicas[1:]:
            for q, p in zip(model.parameters(), replicas[0].parameters()):
                q.copy_(p)


def _recipe(preset_name, preset, data, component, epochs, batch_size,
            learning_rate, seed, schedule, clip_norm, kernel_init) -> dict:
    """The JAX package's recipe fingerprint, key for key, and the draw the
    weights start from (``"init"``, flax's since the port draws as flax
    does): it pins a checkpoint to the run that wrote it.  The epoch budget
    is part of it only for the schedules it shapes (cosine, plateau); the
    dataset by its size, grid and a strided centre-pixel checksum;
    ``kernel_init`` only when not the default."""
    g = data.fnet.shape[1] // 2
    sig = np.asarray(data.fnet[:: max(1, len(data.fnet) // 8), g, g, :], np.float64)
    recipe = {"preset": preset_name, "component": component,
              "batch_size": batch_size, "lr": learning_rate, "seed": seed,
              "optimizer": preset.optimizer, "schedule": schedule,
              "clip_norm": clip_norm,
              "epochs": epochs if schedule in ("cosine", "plateau") else None,
              "data_n": int(len(data.fnet)), "data_shape": list(data.fnet.shape),
              "data_sig": float(np.abs(sig).sum()), "init": flax_init.DRAW}
    if kernel_init != "lecun_normal":
        recipe["kernel_init"] = kernel_init
    return recipe


def train(
    preset_name: str,
    data: PreparedData,
    component: str = "x",
    epochs: Optional[int] = None,
    batch_size: Optional[int] = None,
    learning_rate: float = 1e-3,
    seed: int = 0,
    init_params: Optional[dict] = None,
    verbose: bool = False,
    optimizer: Optional[str] = None,
    schedule: Optional[str] = None,
    clip_norm: Optional[float] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 25,
    mesh: Optional[Mesh] = None,
    kernel_init: str = "lecun_normal",
    *,
    device="cuda",
    allow_tf32: bool = False,
) -> TrainResult:
    """Train one velocity-component surrogate.  Pass ``init_params`` (a
    ``state_dict``; ``models.state_dict_from_flax`` carries the JAX
    package's parameters across) to fine-tune from saved weights at a lower
    LR (the ``CNN_test.py`` capability, reference: ``CNN_test.py:100-106``);
    without it the weights are drawn from ``seed``.

    ``optimizer`` overrides the preset's choice ('rmsprop' | 'adam');
    ``schedule`` and ``clip_norm`` as in ``lr_schedule`` and
    ``clip_by_global_norm``.  The loss is ``mean((pred - y)**2)``; each
    epoch's loss is the float32 mean of its steps' losses, fetched once per
    epoch, and ``val_loss`` one forward over the validation set.

    ``checkpoint_path`` enables mid-run resume: every ``checkpoint_every``
    epochs (and after the last) the model, the optimiser state, the
    schedule's count and the history are written atomically; a restarted
    call with the same arguments continues from the stored epoch with the
    same shuffle trajectory.  A checkpoint of another recipe, or whose
    progress exceeds ``epochs``, is ignored and the run starts fresh.

    ``mesh`` (``parallel.make_mesh((dp, 1), devices)``; devices may repeat)
    trains data-parallel over the mesh's first axis: one replica per entry
    takes its equal slice of each minibatch (``batch_size`` must divide over
    it), the gradients are averaged onto the first entry's device, one
    optimiser step runs there and the parameters are copied back to the
    replicas.  The minibatch schedule is the single-device run's, so the
    results match it up to float reduction order.  With a mesh its devices
    take the place of ``device``.

    ``device`` is where the run goes (the card by default; raises without
    one).  Float32 convolutions, forward and backward, run without TF32
    unless ``allow_tf32=True``, which needs CUDA devices."""
    preset = PRESETS[preset_name]
    if optimizer is not None:
        preset = dataclasses.replace(preset, optimizer=optimizer)
    check_grid(preset, data.fnet.shape[1], data.fnet.shape[2])
    epochs = preset.epochs if epochs is None else epochs
    batch_size = preset.batch_size if batch_size is None else batch_size
    devices = (_replica_devices(mesh, batch_size) if mesh is not None
               else [resolve_device(device)])
    if allow_tf32 and any(d.type != "cuda" for d in devices):
        raise ValueError(f"allow_tf32=True needs CUDA devices (TF32 is cuDNN's), not {devices}")
    first = devices[0]

    model = make_model(preset_name, kernel_init=kernel_init, allow_tf32=allow_tf32, seed=seed)
    if init_params is not None:
        model.load_state_dict(init_params)
    replicas = [model.to(first)] + [copy.deepcopy(model).to(d) for d in devices[1:]]

    x = torch.from_numpy(np.ascontiguousarray(data.fnet)).to(first)
    aux = (None if data.aux is None
           else torch.from_numpy(np.ascontiguousarray(data.aux)).to(first))
    y = torch.from_numpy(np.ascontiguousarray(data.targets[component])).to(first)
    tr_idx, va_idx = train_val_split(len(x))
    steps_per_epoch = max(1, len(tr_idx) // batch_size)
    opt = Optimizer(preset, model.parameters(), learning_rate, schedule=schedule,
                    total_steps=steps_per_epoch * epochs, clip_norm=clip_norm)

    history = {"loss": [], "val_loss": []}
    shuffle_rng = np.random.default_rng(seed)
    va = torch.from_numpy(va_idx).to(first)
    xv, yv = x[va], y[va]
    auxv = None if aux is None else aux[va]
    recipe = _recipe(preset_name, preset, data, component, epochs, batch_size,
                     learning_rate, seed, schedule, clip_norm, kernel_init)

    start_epoch = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        loaded = _load_train_checkpoint(checkpoint_path, recipe, first, model, opt,
                                        steps_per_epoch)
        if loaded is not None and loaded[4] > epochs:
            loaded = None  # stored progress exceeds this run's budget
        if loaded is None:
            print(f"[{preset_name}/{component}] checkpoint at "
                  f"{checkpoint_path} is from a different recipe or budget; "
                  "starting fresh", flush=True)
        else:
            model_sd, opt_sd, opt.count, history, start_epoch = loaded
            model.load_state_dict(model_sd)
            opt.opt.load_state_dict(opt_sd)
            for _ in range(start_epoch):  # replay the shuffle trajectory
                shuffle_rng.permutation(tr_idx)
            if verbose:
                print(f"[{preset_name}/{component}] resumed at epoch "
                      f"{start_epoch}/{epochs} from {checkpoint_path}")
    _sync_replicas(replicas)

    for ep in range(start_epoch, epochs):
        # the epoch's order goes up once: a pageable upload per step would
        # wait for the queued work
        order = torch.from_numpy(shuffle_rng.permutation(tr_idx)).to(first)
        losses = []
        for s in range(steps_per_epoch):
            bi = order[s * batch_size:(s + 1) * batch_size]
            losses.append(loss_and_grads(replicas, x[bi], None if aux is None else aux[bi],
                                         y[bi]))
            opt.step()
            _sync_replicas(replicas)
        ep_loss = float(torch.stack(losses).mean())
        with torch.no_grad():
            vl = float(_mse(model, xv, auxv, yv))
        history["loss"].append(ep_loss)
        history["val_loss"].append(vl)
        if verbose:
            print(f"[{preset_name}/{component}] epoch {ep + 1}/{epochs} "
                  f"loss={history['loss'][-1]:.3e} val={vl:.3e}")
        if checkpoint_path and (
            (ep + 1) % checkpoint_every == 0 or ep + 1 == epochs
        ):
            _save_train_checkpoint(checkpoint_path, model, opt, history, ep + 1, recipe)

    params = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    return TrainResult(params=params, history=history, preset=preset, component=component)


def _save_train_checkpoint(path, model: CavityCNN, opt: Optimizer, history, epoch,
                           recipe) -> None:
    """Atomic (tmp + rename) mid-training snapshot: an 8-byte little-endian
    header length, the JSON header (epoch, history and the recipe
    fingerprint that makes resume refuse foreign checkpoints), then a
    ``torch.save`` blob of (model state_dict, optimiser state_dict, the
    schedule's count)."""
    blob = io.BytesIO()
    torch.save((model.state_dict(), opt.opt.state_dict(), opt.count), blob)
    header = json.dumps({"epoch": epoch, "history": history,
                         "recipe": recipe}).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(len(header).to_bytes(8, "little"))
        fh.write(header)
        fh.write(blob.getvalue())
    os.replace(tmp, path)


# A torch.save blob is a zip archive; the JAX package's is flax msgpack.
_ZIP_MAGIC = b"PK\x03\x04"


def _load_train_checkpoint(path, recipe, device, model: CavityCNN, opt: Optimizer,
                           steps_per_epoch: int):
    """Returns (model state_dict, optimiser state_dict, count, history,
    epoch) on ``device``, or None when the checkpoint was written by a
    different recipe and must not be resumed from.  The blob is this
    package's ``torch.save`` or the JAX package's flax msgpack of
    ``(params, opt_state)``, told apart by its first bytes; ``model`` and
    ``opt`` (this run's) give a JAX blob its places.  A JAX recipe names no
    draw: its run started from flax's, ``flax_init.DRAW``; a checkpoint of
    this package that names none is of the draw before it, and is refused."""
    with open(path, "rb") as fh:
        hlen = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(hlen))
        blob = fh.read()
    stored = header.get("recipe")
    if isinstance(stored, dict) and not blob.startswith(_ZIP_MAGIC):
        stored = {**stored, "init": flax_init.DRAW}
    if stored != recipe:
        return None
    epoch = int(header["epoch"])
    if blob.startswith(_ZIP_MAGIC):
        model_sd, opt_sd, count = torch.load(io.BytesIO(blob), map_location=device,
                                             weights_only=True)
    else:
        model_sd, opt_sd, count = _from_optax(flax_msgpack.msgpack_restore(blob),
                                              recipe, model, opt, device,
                                              epoch * steps_per_epoch)
    return model_sd, opt_sd, count, header["history"], epoch


def _from_optax(tree: dict, recipe: dict, model: CavityCNN, opt: Optimizer, device,
                updates: int):
    """The JAX package's ``(params, opt_state)`` tree as (model state_dict,
    optimiser state_dict, count).  ``opt_state`` is optax's chain state:
    with ``clip_norm`` the clipping's empty state, then the base; the base
    is ``(scale_by_adam (count, mu, nu) | scale_by_rms (nu), the
    learning rate's state (its count under a schedule), ...)``.  The moments
    are trees of the parameters' shapes and take the parameters' layout
    change (``models.state_dict_from_flax``).  The count is the schedule's,
    else Adam's, else ``updates`` (a constant rate reads none)."""
    preset = model.preset
    params, state = tree["0"], tree["1"]
    if recipe["clip_norm"] is not None:
        state = state["1"]
    base, rate = state["0"], state["1"]
    moments = {k: state_dict_from_flax(preset, base[k]) for k in ("mu", "nu") if k in base}
    adam = recipe["optimizer"] == "adam"
    if set(moments) != ({"mu", "nu"} if adam else {"nu"}):
        raise ValueError(f"the checkpoint's optimiser state holds {sorted(moments)}, "
                         f"not {recipe['optimizer']}'s moments")
    per_param = {}
    for i, (name, _) in enumerate(model.named_parameters()):
        if adam:
            per_param[i] = {"step": torch.tensor(float(base["count"])),
                            "exp_avg": moments["mu"][name].to(device),
                            "exp_avg_sq": moments["nu"][name].to(device)}
        else:
            per_param[i] = {"nu": moments["nu"][name].to(device)}
    count = int(rate["count"]) if "count" in rate else (
        int(base["count"]) if adam else updates)
    opt_sd = {"state": per_param, "param_groups": opt.opt.state_dict()["param_groups"]}
    model_sd = {k: v.to(device) for k, v in state_dict_from_flax(preset, params).items()}
    return model_sd, opt_sd, count


def fine_tune(preset_name: str, data: PreparedData, params: dict,
              component: str = "x", epochs: int = 50,
              learning_rate: float = 1e-4, **kw) -> TrainResult:
    """Refit saved weights at a lower LR (reference: ``CNN_test.py:100-106``,
    RMSprop lr=1e-4)."""
    return train(preset_name, data, component=component, epochs=epochs,
                 learning_rate=learning_rate, init_params=params, **kw)


# ---------------------------------------------------------------------------
# Persistence (replaces Keras .h5 saves, reference: CNN_Eight.py:161)
# ---------------------------------------------------------------------------

def save_weights(result: TrainResult, out_dir: str,
                 scalers: Optional[dict] = None) -> str:
    """``{preset}_{component}.pt`` (the ``state_dict``) beside the JSON
    sidecar of the preset, component, history and scalers."""
    os.makedirs(out_dir, exist_ok=True)
    stem = f"{result.preset.name}_{result.component}"
    path = os.path.join(out_dir, stem + ".pt")
    torch.save(result.params, path)
    meta = {
        "preset": result.preset.name,
        "component": result.component,
        "history": result.history,
    }
    if scalers is not None:
        meta["scalers"] = scalers
    with open(os.path.join(out_dir, stem + ".json"), "w") as fh:
        json.dump(meta, fh)
    return path


def load_weights(preset_name: str, component: str, out_dir: str,
                 example: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None,
                 device="cpu"):
    """``(state_dict, meta)`` of ``save_weights``' files, the tensors on
    ``device``; raises if they do not fit the preset.  Where no
    ``<stem>.pt`` is, the JAX package's ``<stem>.msgpack`` is read and its
    parameters carried across (``models.state_dict_from_flax``).  ``example``
    stays for the JAX package's signature (its template); nothing reads it."""
    device = resolve_device(device)
    stem = f"{preset_name}_{component}"
    pt = os.path.join(out_dir, stem + ".pt")
    flax_path = os.path.join(out_dir, stem + ".msgpack")
    if os.path.exists(pt):
        params = torch.load(pt, map_location=device, weights_only=True)
    elif os.path.exists(flax_path):
        params = {k: v.to(device) for k, v in
                  state_dict_from_flax(PRESETS[preset_name], flax_msgpack.load(flax_path)).items()}
    else:
        raise FileNotFoundError(f"neither {stem}.pt nor {stem}.msgpack in {out_dir}")
    make_model(preset_name).load_state_dict(params)
    meta_path = os.path.join(out_dir, stem + ".json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
    return params, meta


def plot_history(history: dict, path: str) -> str:
    """Loss-history PNG (reference: ``CNN_Eight.py:153-159``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.semilogy(history["loss"], label="train")
    ax.semilogy(history["val_loss"], label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("MSE")
    ax.legend()
    ax.grid(alpha=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
