#!/usr/bin/env python
"""The surrogate pipeline at its own scale over the cards of one machine:
the whole 500-cavity sweep and its top-up, one process per card, then the
assembly, the dataset check on every chunk and ``scripts/train_full.py``'s
runs, each through the port's own scripts' command lines.

1. The chunks of JAX's record (``docs/artifacts/ml_full/dataset_metadata.json``:
   consecutive groups of ``--n-cav`` = 7 Re values from Re 100) are cut into
   one contiguous range of whole chunks per card, balanced on the record's
   steps per chunk (the largest range as small as a contiguous cut makes
   it: ``balanced_ranges``).  Card k runs, in its own directory
   ``<out>/card<k>`` (``progress.jsonl``, ``topup.jsonl`` and the resume by
   Re are per directory), ``scripts/torch_datagen_full.py --re-start A
   --re-stop B --out <out>/card<k>`` and then ``scripts/torch_datagen_topup.py
   --data <out>/card<k>``, with ``CUDA_VISIBLE_DEVICES=k``.
2. The chunk files are merged into ``<out>/chunks`` (and the logs into
   ``<out>``), and ``torch_datagen_full.py --assemble-partial --out <out>``
   writes the four-array layout and ``metadata.json``.
3. ``scripts/torch_check_dataset.py <out>/metadata.json <record>`` holds
   every chunk to JAX's record with its bounds unchanged, and
   ``scripts/torch_check_dataset_determinism.py`` holds it to the port's
   own earlier sweep (``--determinism-record``, exactly: steps, converged
   and failed counts per chunk); a miss is recorded and the run goes on.
4. The training runs (``JOBS``: the invocations of ``scripts/chain_r3_b.sh``
   through ``scripts/torch_train_full.py``, and the port's scripts of the
   other runs that read the whole dataset), each in a process of its own on
   free cards, the gated jobs (``BOUNDS`` and ``cnn_one_192``) first and
   longest first among them, ``cnn_eight``'s reading last; a job is
   started only if its estimate (``EPOCH_S``) ends before ``--deadline``.
   A model's training takes ``--group`` cards (``CUDA_VISIBLE_DEVICES``
   and ``--data-parallel``), or its own count where ``--jobs`` names it
   ``<job>@<k>``; ``<job>.x`` and ``<job>.y`` train one component each,
   and once both have ended ``<job>.eval`` evaluates the two saved halves
   (and each pair of their snapshots) together on one card
   (``--evaluate-only``).  Each model's held-out numbers are held to
   ``BOUNDS`` (``cnn_eight``'s plateau and the other scripts' runs are
   readings, not bounds).

Every record is copied into ``--records`` as it is written: each card's
logs while it runs, then ``ml_full/metadata.json``, ``ml_dataset.json``,
``determinism.json``,
each job's summary and weight sidecars (not the weights), the summaries
merged as the JAX records lay them out (``ml_full/summary.json``,
``ml_full_b/summary.json``), beside each the held-out truth that a model's
evaluation kept (``held_out_truth.npz``, the last evaluated model's in its
layout), and ``driver.json`` (the plan, the cards' ``nvidia-smi`` name and
power limit, each process's exit code and seconds, the assembly's seconds,
the bounds).  A failed process, a dataset check that misses or a missed
bound makes the exit code 1, at the end.

Usage (from the repository root, on a machine with four cards):

    python scripts/torch_pipeline_cards.py [--out data/ml_full] [--deadline 1950]

``cnn_nine``'s x half on cards 0-1 and its y half on cards 2-3:
``--jobs cnn_nine.x,cnn_nine.y --group 2``.  ``cnn_ten``'s halves on one
card each and the x half of ``cnn_nine`` from seed 1 over the other two:
``--jobs cnn_ten.x,cnn_ten.y,cnn_nine_s1.x@2``.  The other whole-dataset
runs, one card each: ``--jobs
diagnose_cnn_eight,eight_faithful,cnn_eight.x,resume_eight_y,early_presets``.
``cnn_nine``'s x half from the JAX package's own initial weights, in
float32 and at the TPU's convolution precision, over two cards each:
``--jobs cnn_nine_jax0.x@2,cnn_nine_jax0_tpu.x@2``.

``--cards 0,0`` runs two ranges on the one card 0; ``--device cpu`` runs
every process on the CPU; ``--re-stop``, ``--sweep-args`` and
``--topup-args`` cut the sweep down (the CPU tests do).
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import shutil
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECORD = os.path.join(ROOT, "docs", "artifacts", "ml_full", "dataset_metadata.json")
RECORDS = os.path.join(ROOT, "chiprun_out", "pipeline_cards")
# the port's own whole sweep (four cards, one NVIDIA H100 80GB HBM3 each)
DETERMINISM_RECORD = os.path.join(ROOT, "docs", "artifacts", "torch", "ml_full", "metadata.json")
RE_STEP = 10.0
# The JAX package's own initial weights of cnn_nine: flax's init from
# PRNGKey(0), as JAX's train drew them for its record's two halves
# (tests/test_torch_ml_jax_init.py writes it and holds it to a fresh draw)
JAX_INIT = os.path.join(ROOT, "docs", "artifacts", "torch", "init", "cnn_nine_prngkey0.msgpack")
# the held-out record a model's evaluation keeps (torch_train_full.TRUTH)
TRUTH = "held_out_truth.npz"

# JAX's training runs (scripts/chain_r3_b.sh:37-45, :67-68; cnn_eight's y
# half came from scripts/resume_eight_y.py with the same recipe): the script
# of each, its arguments, the summary its record is in, and the epochs it
# trains by EPOCH_S's keys.  The other runs that read the whole dataset
# (scripts/train_eight_faithful.py, train_early_presets.py,
# diagnose_cnn_eight.py, resume_eight_y.py) by their port's scripts: named
# here so that a call can run them, each on one card.  cnn_ten keeps the
# weights of its last 40 epochs every tenth (--snapshots), and cnn_nine_s1
# is cnn_nine's run from the initial weights and shuffle of seed 1 with
# those of its last 50: whether a late epoch's score is a draw or a fault.
# The pair cnn_nine_jax0 and cnn_nine_jax0_tpu trains cnn_nine at full
# scale from JAX's own initial weights read from a file (JAX_INIT) and seed
# 0's shuffle, in float32 and at the TPU's convolution precision
# (--tpu-precision), each keeping the weights of its last 50 epochs; since
# the port draws as flax does, cnn_nine's own run starts from those weights
# too.
class Job(NamedTuple):
    script: str
    argv: list
    layout: str
    epochs: dict
    model: str = ""          # the model a torch_train_full.py job trains
    summary: str = "summary.json"    # where under its --out the script writes it


JOBS = {
    "cnn_eight": Job("torch_train_full", ["--models", "cnn_eight", "--early-preset", "",
                                          "--fine-tune-epochs", "0"], "ml_full",
                     {"cnn_eight": 2 * 600}, "cnn_eight"),
    "cnn_nine": Job("torch_train_full", ["--models", "cnn_nine", "--early-preset", "",
                                         "--fine-tune-epochs", "0"], "ml_full",
                    {"cnn_nine": 2 * 350}, "cnn_nine"),
    "cnn_ten": Job("torch_train_full", ["--models", "cnn_ten", "--early-preset", "",
                                        "--fine-tune-epochs", "0", "--epochs-scale", "0.5",
                                        "--snapshots", "40"],
                   "ml_full_b", {"cnn_ten": 2 * 200}, "cnn_ten"),
    "cnn_nine_s1": Job("torch_train_full", ["--models", "cnn_nine", "--early-preset", "",
                                            "--fine-tune-epochs", "0", "--seed", "1",
                                            "--snapshots", "50"],
                       "ml_full_s1", {"cnn_nine": 2 * 350}, "cnn_nine"),
    "cnn_nine_jax0": Job("torch_train_full", [
        "--models", "cnn_nine", "--early-preset", "", "--fine-tune-epochs", "0",
        "--init-from", JAX_INIT, "--snapshots", "50"], "ml_full_jax0", {"cnn_nine": 2 * 350},
        "cnn_nine"),
    "cnn_nine_jax0_tpu": Job("torch_train_full", [
        "--models", "cnn_nine", "--early-preset", "", "--fine-tune-epochs", "0",
        "--init-from", JAX_INIT, "--snapshots", "50", "--tpu-precision"], "ml_full_jax0_tpu",
        {"cnn_nine_tpu": 2 * 350}, "cnn_nine"),
    "cnn_one_192": Job("torch_train_full", ["--models", "", "--early-epochs", "80"],
                       "ml_full_b", {"cnn_one_192": 80}),
    "resume_eight_y": Job("torch_resume_eight_y", [], "ml_full", {"cnn_eight": 600}),
    "eight_faithful": Job("torch_train_eight_faithful", [], "ml_full/cnn_eight_faithful",
                          {"cnn_eight": 2 * 600},
                          summary=os.path.join("cnn_eight_faithful", "summary.json")),
    "early_presets": Job("torch_train_early_presets", [], "ml_early",
                         {**{f"{m}_192": 120 for m in ("cnn_two", "cnn_three", "cnn_four",
                                                       "cnn_five", "cnn_six", "cnn_seven")},
                          "cnn_seven_384": 60}),
    "diagnose_cnn_eight": Job("torch_diagnose_cnn_eight", [], "cnn_eight_diag",
                              {"cnn_eight": 4 * 150, "cnn_eight_auxin": 150,
                               "cnn_eight_ms": 150, "cnn_eight_192": 150}),
}
# the jobs run when --jobs is not given: train_full.py's recorded runs
TRAIN_FULL_JOBS = ("cnn_eight", "cnn_nine", "cnn_ten", "cnn_one_192")
# A train_full job named "<job>.x" or "<job>.y" trains that component
# alone (--components), over a group of --group cards (--data-parallel);
# once both halves of a model have ended, "<job>.eval" evaluates the two
# saved halves together on one card (--evaluate-only) and is held to the
# model's bound.  NEEDS: the job whose weights of a component another job
# reads: resume_eight_y starts after cnn_eight.x or the whole cnn_eight,
# whichever runs, and reads its x weights.
HALVES = ("x", "y")
NEEDS = {"resume_eight_y": ("cnn_eight", "x")}
# Each training job's model by key: its preset, its grid and the seconds an
# epoch (training and validation) on 493 cavities at batch 20 (cnn_one,
# cnn_two and cnn_three at their batch of 5), Adam, TF32 off, on one NVIDIA
# H100 80GB HBM3 at 700 W; a key "<model>@<k>" is the same over k cards of
# one process (ml.train(mesh=)), where measured.  cnn_eight and
# cnn_one_192: torch_train_full.py's train_s over the epochs of this
# script's four-card run (600 epochs of x, 80; their first epoch's start-up
# included).  The others: scripts/torch_train_epochs.py (which times the
# keys of this table), each model's training steps and one validation
# forward on the wall clock, rounded up (cnn_nine and cnn_ten read there at
# 1.5551 and 1.4147, cnn_eight at 0.3801, 0.92 of the whole run's,
# cnn_one_192 at 0.5007; over two cards cnn_nine 0.9618, cnn_ten 0.9286,
# cnn_eight 0.2856, 1.63x, 1.53x and 1.34x one card's); chip_smoke.py's
# phase (t) reads each one-card key again.  cnn_two_192's and
# cnn_eight_192's steps (about 5 ms) are bound by the host's launches: six
# readings each on NVIDIA H100 80GB HBM3 cards spread with the host's load,
# 0.4356-0.9680 and 0.1056-0.2246 s an epoch, and each estimate is the
# geometric middle of its spread.  JOB_SETUP_S: a job's start, the dataset's read
# and the evaluation beside train_s (15.6-21.2 s).  cnn_nine_tpu
# (cnn_nine_jax0_tpu's epoch, TPU_PRECISION: with every convolution at the
# TPU's precision) is chip_smoke.py's phase (t)
# reading, 1.7570 (1.12x cnn_nine's 1.5673 in the same call), rounded up;
# cnn_nine_tpu@2 is that reading times cnn_nine's two-card over one-card
# ratio, 0.97 / 1.57, rounded up (an estimate, not a reading).
EPOCHS = {
    "cnn_nine": ("cnn_nine", 384, 1.57), "cnn_ten": ("cnn_ten", 384, 1.43),
    "cnn_eight": ("cnn_eight", 384, 0.415), "cnn_one_192": ("cnn_one", 192, 0.735),
    "cnn_nine@2": ("cnn_nine", 384, 0.97), "cnn_ten@2": ("cnn_ten", 384, 0.93),
    "cnn_eight@2": ("cnn_eight", 384, 0.29),
    "cnn_two_192": ("cnn_two", 192, 0.65), "cnn_three_192": ("cnn_three", 192, 0.57),
    "cnn_four_192": ("cnn_four", 192, 0.18), "cnn_five_192": ("cnn_five", 192, 0.16),
    "cnn_six_192": ("cnn_six", 192, 0.16), "cnn_seven_192": ("cnn_seven", 192, 0.14),
    "cnn_seven_384": ("cnn_seven", 384, 0.38), "cnn_eight_192": ("cnn_eight", 192, 0.15),
    "cnn_eight_auxin": ("cnn_eight_auxin", 384, 0.40),
    "cnn_eight_ms": ("cnn_eight_ms", 384, 1.37),
    "cnn_nine_tpu": ("cnn_nine", 384, 1.76), "cnn_nine_tpu@2": ("cnn_nine", 384, 1.09),
}
TPU_PRECISION = ("cnn_nine_tpu",)
EPOCH_S = {key: s for key, (_, _, s) in EPOCHS.items()}
JOB_SETUP_S = 40.0
POLL_S = 0.5               # seconds between looks at the running processes

# The held-out bounds at every one of the seven Re (the port trains in
# float32, TF32 off, from its own initial weights): (R^2(ux) at least,
# relative L2 at most); cnn_one at 192^2: its final validation MSE at most
# ONE_192_VAL_MSE and its loss falling ONE_192_FALL-fold.  cnn_eight's
# record sits on the mean-predictor plateau: relL2 above PLATEAU_REL_L2 is
# read, not bounded; so are the other scripts' runs.
BOUNDS = {"cnn_nine": (0.999, 0.05), "cnn_ten": (0.995, 0.08)}
ONE_192_VAL_MSE = 10 * 2.412e-5
ONE_192_FALL = 100.0
PLATEAU_REL_L2 = 0.3


def record_chunks(record: dict, re_start: float = 100.0, re_stop: float = 5100.0) -> list:
    """``(re_lo, re_hi, steps)`` of the record's chunks within
    ``[re_start, re_stop)``, in Re order."""
    chunks = sorted((c["re_lo"], c["re_hi"], c["steps"]) for c in record["chunks"])
    return [c for c in chunks if re_start <= c[0] and c[1] < re_stop]


def balanced_ranges(steps: list, n: int) -> list:
    """Cut ``steps`` (per chunk, in order) into ``n`` contiguous non-empty
    runs whose largest sum is as small as any such cut makes it; returns
    each run's ``(first, last + 1)`` indices.  Among the cuts that reach
    that largest sum, each run ends as late as it can (the cards' loads
    rise towards the last)."""
    if not 1 <= n <= len(steps):
        raise ValueError(f"{len(steps)} chunks cannot make {n} non-empty ranges")
    lo, hi = max(steps), sum(steps)
    while lo < hi:                       # the least feasible largest sum
        mid = (lo + hi) // 2
        runs, acc = 1, 0
        for s in steps:
            if acc + s > mid:
                runs, acc = runs + 1, 0
            acc += s
        lo, hi = (mid + 1, hi) if runs > n else (lo, mid)
    cuts, end = [], len(steps)
    for k in range(n - 1, 0, -1):        # from the end, each run as long as it may be
        start, acc = end, 0
        while start - 1 >= k and acc + steps[start - 1] <= lo:
            start -= 1
            acc += steps[start]
        cuts.append(start)
        end = start
    bounds = [0, *reversed(cuts), len(steps)]
    return list(zip(bounds[:-1], bounds[1:]))


def card_ranges(record: dict, n: int, re_start: float = 100.0,
                re_stop: float = 5100.0) -> list:
    """One contiguous range of whole chunks per card: its ``--re-start``
    and ``--re-stop``, chunk count and the record's steps."""
    chunks = record_chunks(record, re_start, re_stop)
    out = []
    for a, b in balanced_ranges([c[2] for c in chunks], n):
        part = chunks[a:b]
        out.append({"re_start": part[0][0], "re_stop": part[-1][1] + RE_STEP,
                    "chunks": len(part), "steps": int(sum(c[2] for c in part))})
    return out


class Records:
    """The run's records under ``root``, written as they come."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.driver = {"started": time.strftime("%Y-%m-%dT%H:%M:%S"), "processes": []}

    def copy(self, src: str, rel: str) -> None:
        if os.path.exists(src):
            dst = os.path.join(self.root, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(src, dst)

    def write(self, rel: str, obj) -> None:
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "w") as fh:
            json.dump(obj, fh, indent=1)
        os.replace(path + ".tmp", path)

    def save(self) -> None:
        self.write("driver.json", self.driver)


class Proc:
    """One script run in a process of its own, its output in a log."""

    def __init__(self, name: str, argv: list, card, device: str, log_path: str):
        """``card`` is one card's index among those this process sees, or a
        tuple of them (the process then sees that group)."""
        self.name, self.argv, self.card = name, argv, card
        env = dict(os.environ)
        if device == "cuda":
            visible = os.environ.get("CUDA_VISIBLE_DEVICES")
            group = card if isinstance(card, tuple) else (card,)
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                visible.split(",")[c] if visible else str(c) for c in group)
        self.log_path = log_path
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        self.log = open(log_path, "w")
        self.t0 = time.time()
        self.p = subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                                  stdout=self.log, stderr=subprocess.STDOUT)
        print(f"[{name}] card {card}: {shlex.join(argv)}", flush=True)

    def poll(self):
        rc = self.p.poll()
        if rc is not None and not self.log.closed:
            self.log.close()
            self.seconds = round(time.time() - self.t0, 2)
            print(f"[{self.name}] exit {rc} after {self.seconds} s", flush=True)
        return rc

    def kill(self) -> None:
        if self.p.poll() is None:
            self.p.kill()
            self.p.wait()
        self.poll()

    def row(self) -> dict:
        return {"name": self.name, "card": self.card, "argv": self.argv,
                "rc": self.p.poll(), "seconds": getattr(self, "seconds", None)}


def script(name: str) -> str:
    return os.path.join("scripts", f"{name}.py")


def run(procs: list, records: Records, on_poll=None) -> None:
    """Wait for ``procs`` (to which ``on_poll``, called first every
    ``POLL_S`` seconds, may add), then record their exit codes and seconds;
    a process still running when this is left is killed."""
    try:
        while True:
            if on_poll is not None:
                on_poll()
            if all(p.poll() is not None for p in procs):
                break
            time.sleep(POLL_S)
    finally:
        for p in procs:
            p.kill()
        records.driver["processes"] += [p.row() for p in procs]
        records.save()


def sweep_cards(args, ranges, cards, records: Records) -> bool:
    """Each card's sweep and then its top-up, all cards at once; their logs
    copied into the records as they grow.  True if every process ended
    with 0."""
    dirs = [os.path.join(args.out, f"card{k}") for k in range(len(ranges))]
    sweep_args, topup_args = shlex.split(args.sweep_args), shlex.split(args.topup_args)
    stages = [[script("torch_datagen_full"), *sweep_args,
               "--re-start", f"{r['re_start']:g}", "--re-stop", f"{r['re_stop']:g}",
               "--out", d, "--device", args.device] for r, d in zip(ranges, dirs)]
    topups = [[script("torch_datagen_topup"), *topup_args, "--data", d,
               "--device", args.device] for d in dirs]
    procs = [Proc(f"card{k}: sweep", argv, cards[k], args.device,
                  os.path.join(records.root, f"card{k}", "sweep.log"))
             for k, argv in enumerate(stages)]
    started = {k: False for k in range(len(ranges))}
    ok = [True]

    def follow():
        for k, d in enumerate(dirs):
            for log in ("progress.jsonl", "topup.jsonl"):
                records.copy(os.path.join(d, log), os.path.join(f"card{k}", log))
            if not started[k] and procs[k].poll() is not None:
                started[k] = True
                if procs[k].poll() != 0:
                    ok[0] = False
                    continue
                procs.append(Proc(f"card{k}: top-up", topups[k], cards[k], args.device,
                                  os.path.join(records.root, f"card{k}", "topup.log")))

    run(procs, records, follow)
    return ok[0] and all(p.poll() == 0 for p in procs)


def merge(args, n_cards: int) -> None:
    """Every card's chunk files into ``<out>/chunks`` (linked where the file
    system allows), its logs appended to ``<out>``'s, in card order."""
    chunk_dir = os.path.join(args.out, "chunks")
    os.makedirs(chunk_dir, exist_ok=True)
    for log in ("progress.jsonl", "topup.jsonl"):
        with open(os.path.join(args.out, log), "w") as out:
            for k in range(n_cards):
                path = os.path.join(args.out, f"card{k}", log)
                if os.path.exists(path):
                    with open(path) as fh:
                        out.write(fh.read())
    for k in range(n_cards):
        src_dir = os.path.join(args.out, f"card{k}", "chunks")
        for fn in sorted(os.listdir(src_dir)) if os.path.isdir(src_dir) else ():
            src, dst = os.path.join(src_dir, fn), os.path.join(chunk_dir, fn)
            if os.path.exists(dst):
                raise FileExistsError(f"{fn} in two cards' directories")
            try:
                os.link(src, dst)
            except OSError:
                shutil.copyfile(src, dst)


def job_spec(job: str) -> tuple:
    """``(base, part, Job)`` of a job's name: ``part`` is '' for a whole job,
    a component for a half, or 'eval'."""
    base, _, part = job.partition(".")
    if base not in JOBS or part not in ("", *HALVES, "eval") or (part and not JOBS[base].model):
        raise ValueError(f"unknown job {job!r}")
    return base, part, JOBS[base]


def epoch_s(key: str, k: int = 1) -> float:
    """Seconds an epoch of ``key`` over ``k`` cards: its own reading where
    there is one, else the one card's."""
    return EPOCH_S.get(f"{key}@{k}", EPOCH_S[key])


def job_cards(job: str, group) -> int:
    """The cards a job takes: for training a model of ``torch_train_full.py``
    (whole or half) ``group``, or the job's own count where ``group`` maps
    jobs to counts (``parse_jobs``), else one."""
    _, part, spec = job_spec(job)
    if not spec.model or part == "eval":
        return 1
    return group[job] if isinstance(group, dict) else group


def parse_jobs(jobs: str, group: int) -> dict:
    """``--jobs``' names in order, each with the cards it takes: ``<job>@<k>``
    gives a model's training its own ``k``, any other ``group``
    (``job_cards``); a model both of whose halves are listed gains its
    ``.eval``."""
    cards = {}
    for item in filter(None, jobs.split(",")):
        job, at, k = item.partition("@")
        n = job_cards(job, group)
        if at:
            if job_cards(job, int(k)) != int(k) or int(k) < 1:
                raise ValueError(f"{item!r}: only a model's training takes its own card count")
            n = int(k)
        if cards.get(job, n) != n:
            raise ValueError(f"{job!r} named with {cards[job]} and {n} cards")
        cards[job] = n
    for job in list(cards):
        base, part, _ = job_spec(job)
        if part == HALVES[-1] and all(f"{base}.{c}" in cards for c in HALVES):
            cards[f"{base}.eval"] = 1
    return cards


def job_estimate(job: str, group=1) -> float:
    _, part, spec = job_spec(job)
    if part == "eval":
        return JOB_SETUP_S
    share = 1 / len(HALVES) if part else 1      # a half trains one of the two components
    k = job_cards(job, group)
    return JOB_SETUP_S + sum(n * share * epoch_s(m, k) for m, n in spec.epochs.items())


def job_after(job: str) -> tuple:
    """The jobs that must end before ``job`` starts, where they run."""
    base, part, _ = job_spec(job)
    if part == "eval":
        return tuple(f"{base}.{c}" for c in HALVES)
    if job in NEEDS:
        model, component = NEEDS[job]
        return f"{model}.{component}", model
    return ()


def held_to_bounds(name: str, summary: dict) -> dict:
    """The numbers of model ``name`` (or of the job ``cnn_one_192``) against
    its bound (or, for cnn_eight, the plateau reading; the other scripts'
    runs are readings)."""
    models = summary.get("models", {})
    if name == "cnn_one_192":
        m = models.get(name)
        if m is None:
            return {"ok": False, "why": "no record"}
        val, fall = m["final_val_mse"]["x"], m["first_loss"] / m["final_loss"]
        return {"final_val_mse": val, "bound_val_mse": ONE_192_VAL_MSE, "loss_fall": fall,
                "bound_fall": ONE_192_FALL,
                "ok": val <= ONE_192_VAL_MSE and fall >= ONE_192_FALL}
    if name not in BOUNDS and name != "cnn_eight":
        return {"reading": "no bound", "ok": True}
    m = models.get(name)
    if m is None:
        return {"ok": False, "why": "no record"}
    rows = [{"re": r["re"], "r2_ux": r["r2_ux"], "rel_l2": r["rel_l2"]}
            for r in m["held_out_eval"]]
    if name in BOUNDS:
        r2_min, l2_max = BOUNDS[name]
        for r in rows:
            r["ok"] = r["r2_ux"] >= r2_min and r["rel_l2"] <= l2_max
        return {"bound": {"r2_ux_min": r2_min, "rel_l2_max": l2_max}, "rows": rows,
                "ok": len(rows) == 7 and all(r["ok"] for r in rows)}
    return {"reading": f"on the plateau where relL2 > {PLATEAU_REL_L2}", "rows": rows,
            "on_plateau": all(r["rel_l2"] > PLATEAU_REL_L2 for r in rows),
            "seed": m.get("seed"), "ok": True}


def merge_summary(records: Records, layout: str, job_summary: dict) -> None:
    """The job's summary merged into the records' ``<layout>/summary.json``
    as the JAX script merges consecutive runs into one (a summary without
    models is written as it is)."""
    if "models" not in job_summary:
        records.write(os.path.join(layout, "summary.json"), job_summary)
        return
    path = os.path.join(records.root, layout, "summary.json")
    summary = {"models": {}}
    if os.path.exists(path):
        with open(path) as fh:
            summary = json.load(fh)
    models = summary.pop("models")
    summary.update({k: v for k, v in job_summary.items() if k != "models"})
    models.update(job_summary["models"])
    summary["models"] = models
    records.write(os.path.join(layout, "summary.json"), summary)


def gated(job: str) -> bool:
    """Whether the job's numbers (or, for a half, its model's) are held to a
    bound, not read."""
    base, _, spec = job_spec(job)
    return (spec.model or base) in BOUNDS or base == "cnn_one_192"


def job_queue(jobs: str, group: int = 1) -> list:
    """The jobs of ``jobs`` (``parse_jobs``) in the order they are started:
    the gated ones first, longest first among them, then the readings."""
    cards = parse_jobs(jobs, group)
    return sorted(cards, key=lambda j: (not gated(j), -job_estimate(j, cards)))


def place(queue: list, free: list, pending: set, failed: set, group,
          fits=lambda job: True) -> tuple:
    """The jobs of ``queue`` that start now, in its order: each whose
    ``job_after`` jobs are neither pending nor failed, for which enough of
    the ``free`` cards are left (the first of them, ``job_cards``) and
    which ``fits``.
    Returns ``([(job, cards)], [(job, why)])``, the jobs started and those
    dropped, and takes both out of ``queue`` and their cards out of
    ``free``."""
    started, dropped = [], []
    for job in list(queue):
        after = job_after(job)
        if any(d in failed for d in after):
            queue.remove(job)
            dropped.append((job, f"{[d for d in after if d in failed]} failed"))
            continue
        n = job_cards(job, group)
        if any(d in pending for d in after) or len(free) < n:
            continue
        queue.remove(job)
        if not fits(job):
            dropped.append((job, f"its estimate {job_estimate(job, group):.0f} s ends past "
                                 "the deadline"))
            continue
        cards, free[:] = tuple(free[:n]), free[n:]
        started.append((job, cards))
    return started, dropped


def job_out(args, job: str) -> str:
    """The job's output directory: ``train/<job>``, a model's evaluation
    that of the model."""
    base, part, _ = job_spec(job)
    return os.path.join(args.out, "train", base if part == "eval" else job)


def job_argv(args, job: str, k: int) -> list:
    """The job's command line: the script's own arguments, the dataset,
    its output directory and the device; a half trains its component, over
    ``k`` cards."""
    _, part, spec = job_spec(job)
    argv = [script(spec.script), *spec.argv, "--data", args.out, "--out", job_out(args, job),
            "--device", args.device]
    if part in HALVES:
        argv += ["--components", part]
    if part == "eval":
        argv.append("--evaluate-only")
    elif spec.model and k > 1:
        argv += ["--data-parallel", str(k)]
    return argv


def link_inputs(args, job: str) -> None:
    """The weights and sidecars that ``job`` reads, of the jobs it runs
    after (a model's half, or the whole model for ``NEEDS``), into
    ``job``'s output directory, where its script reads them; a half's
    snapshots (``snapshots/e<epoch>/``) to the same places."""
    for dep in job_after(job):
        _, part, spec = job_spec(dep)
        component = part if part in HALVES else NEEDS[job][1]
        src = os.path.join(job_out(args, dep), spec.model)
        dst = os.path.join(job_out(args, job), spec.model)
        for dirpath, _, files in os.walk(src):
            into = os.path.join(dst, os.path.relpath(dirpath, src))
            for fn in files:
                if not fn.startswith(f"{spec.model}_{component}."):
                    continue
                os.makedirs(into, exist_ok=True)
                if os.path.exists(os.path.join(into, fn)):
                    os.remove(os.path.join(into, fn))
                try:
                    os.link(os.path.join(dirpath, fn), os.path.join(into, fn))
                except OSError:
                    shutil.copyfile(os.path.join(dirpath, fn), os.path.join(into, fn))


def job_summary(args, job: str, summaries: dict) -> dict:
    """The summary ``job`` wrote; a model's evaluation gains each half's
    ``train_s`` and ``data_parallel`` from theirs."""
    base, part, spec = job_spec(job)
    with open(os.path.join(job_out(args, job), spec.summary)) as fh:
        summary = json.load(fh)
    if part == "eval":
        m = summary["models"][spec.model]
        halves = [summaries[f"{base}.{c}"]["models"][spec.model] for c in HALVES]
        m["train_s"] = {c: h["train_s"][c] for c, h in zip(HALVES, halves)}
        m["data_parallel"] = {c: h.get("data_parallel", 1) for c, h in zip(HALVES, halves)}
    return summary


def train_jobs(args, cards, records: Records, t_start: float) -> bool:
    """The jobs on free cards (``--group`` of them for each model's
    training, or the job's own count), in ``job_queue``'s order as their
    ``job_after`` allow, each started only if its estimate ends before the
    deadline; their summaries and sidecars into the records.  True if every
    job ran, ended with 0 and met its bound."""
    counts = parse_jobs(args.jobs, args.group)
    queue = job_queue(args.jobs, args.group)
    # a card takes one job at a time; on the CPU each entry is a slot
    free = list(cards) if args.device == "cpu" else list(dict.fromkeys(cards))
    running, ok = {}, True
    failed, summaries = set(), {}
    bounds = records.driver.setdefault("bounds", {})
    records.driver["jobs"] = {j: {"n_cards": counts[j],
                                  "estimate_s": round(job_estimate(j, counts), 1)}
                              for j in queue}

    def fits(job):
        return not args.deadline or (time.time() - t_start + job_estimate(job, counts)
                                     <= args.deadline)

    while queue or running:
        for proc, (job, group) in list(running.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del running[proc]
            free.extend(group)
            records.driver["processes"].append(proc.row())
            out = job_out(args, job)
            base, part, spec = job_spec(job)
            if rc != 0 or not os.path.exists(os.path.join(out, spec.summary)):
                ok = False
                failed.add(job)
                bounds[job] = {"ok": False, "why": f"exit code {rc}"}
                continue
            summary = summaries[job] = job_summary(args, job, summaries)
            records.write(os.path.join("train", job, "summary.json"), summary)
            for dirpath, _, files in os.walk(out):
                for fn in files:
                    if fn.endswith(".json") and fn != "summary.json":
                        rel = os.path.relpath(os.path.join(dirpath, fn), out)
                        records.copy(os.path.join(dirpath, fn), os.path.join("train", job, rel))
            if part in HALVES:
                bounds[job] = {"ok": True, "reading": f"the {part} half of {base}"}
            else:
                merge_summary(records, spec.layout, summary)
                records.copy(os.path.join(out, TRUTH), os.path.join(spec.layout, TRUTH))
                bounds[job] = held_to_bounds(spec.model or base, summary)
            ok = ok and bounds[job]["ok"]
            print(f"[{job}] {json.dumps(bounds[job])}", flush=True)
            records.save()
        pending = set(queue) | {job for job, _ in running.values()}
        started, dropped = place(queue, free, pending, failed, counts, fits)
        for job, why in dropped:
            ok = False
            failed.add(job)
            records.driver["jobs"][job]["started"] = False
            bounds[job] = {"ok": False, "why": f"not started: {why}"}
            print(f"[{job}] not started: {why}", flush=True)
        for job, group in started:
            link_inputs(args, job)
            k = len(group)
            records.driver["jobs"][job].update(started=round(time.time() - t_start, 1),
                                               cards=list(group))
            running[Proc(job, job_argv(args, job, k), group if k > 1 else group[0],
                         args.device,
                         os.path.join(records.root, "train", job, "train.log"))] = (job, group)
            records.save()
        if queue and not running and not started and not dropped:
            raise RuntimeError(f"jobs {queue} cannot start on cards {free} (cards a job: "
                               f"{ {j: counts[j] for j in queue} })")
        time.sleep(POLL_S if running else 0)
    records.save()
    return ok


def check_determinism(args, records: Records, meta: str, card) -> int | None:
    """``scripts/torch_check_dataset_determinism.py`` of the assembled
    dataset against ``--determinism-record`` (on the chunks it holds where
    the sweep was cut short of Re 5100); its exit code, None where there is
    no record."""
    if not args.determinism_record:
        return None
    argv = [script("torch_check_dataset_determinism"), meta, args.determinism_record,
            "--out", os.path.join(records.root, "determinism.json")]
    if args.re_stop < 5100.0:
        argv.append("--assemble-partial")
    proc = Proc("determinism", argv, card, args.device,
                os.path.join(records.root, "determinism.log"))
    run([proc], records)
    return proc.poll()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "data", "ml_full"))
    ap.add_argument("--records", default=RECORDS)
    ap.add_argument("--record", default=JAX_RECORD,
                    help="the record that balances the ranges and that the check holds "
                         "the dataset to")
    ap.add_argument("--cards", default=None,
                    help="the card of each range, e.g. 0,1,2,3 (default: every visible "
                         "card once); a card may repeat")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--re-stop", type=float, default=5100.0)
    ap.add_argument("--sweep-args", default="",
                    help="more arguments of torch_datagen_full.py (and its assembly)")
    ap.add_argument("--topup-args", default="", help="more arguments of torch_datagen_topup.py")
    ap.add_argument("--jobs", default=",".join(TRAIN_FULL_JOBS),
                    help="training runs ('' for none): names of JOBS, a model's half as "
                         "<job>.x or <job>.y, a model's training over its own k cards as "
                         "<job>@k (e.g. cnn_nine_s1.x@2)")
    ap.add_argument("--group", type=int, default=1,
                    help="cards that train each model (or half) together, data-parallel, "
                         "where --jobs gives no count of its own")
    ap.add_argument("--determinism-record", default=DETERMINISM_RECORD,
                    help="an earlier sweep's metadata.json that the rebuilt one must equal "
                         "chunk for chunk ('' for no check)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds from the start by which every training job must end")
    args = ap.parse_args(argv)
    t_start = time.time()
    args.out = os.path.abspath(args.out)

    if args.cards is None:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available (pass --device cpu for the CPU)")
        n = torch.cuda.device_count() if args.device == "cuda" else 1
        cards = list(range(n))
    else:
        cards = [int(c) for c in args.cards.split(",")]
    with open(args.record) as fh:
        record = json.load(fh)
    ranges = card_ranges(record, len(cards), re_stop=args.re_stop)
    records = Records(os.path.abspath(args.records))
    records.driver.update(cards=cards, ranges=ranges, out=args.out, device=args.device,
                          deadline=args.deadline, group=args.group)
    if args.device == "cuda":
        records.driver["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    records.save()
    for k, r in enumerate(ranges):
        print(f"card {cards[k]}: Re {r['re_start']:g}..{r['re_stop'] - RE_STEP:g}, "
              f"{r['chunks']} chunks, {r['steps']} steps in JAX's record", flush=True)

    ok = sweep_cards(args, ranges, cards, records)
    records.driver["sweep_s"] = round(time.time() - t_start, 1)
    merge(args, len(ranges))
    assemble = Proc("assemble", [script("torch_datagen_full"), *shlex.split(args.sweep_args),
                                 "--re-stop", f"{args.re_stop:g}", "--assemble-partial",
                                 "--out", args.out, "--device", args.device],
                    cards[0], args.device, os.path.join(records.root, "assemble.log"))
    run([assemble], records)
    records.driver["assemble_s"] = assemble.seconds
    ok = ok and assemble.poll() == 0
    meta = os.path.join(args.out, "metadata.json")
    records.copy(meta, os.path.join("ml_full", "metadata.json"))
    check = Proc("check", [script("torch_check_dataset"), meta, args.record, "--out",
                           os.path.join(records.root, "ml_dataset.json")],
                 cards[0], args.device, os.path.join(records.root, "check.log"))
    run([check], records)
    records.driver["dataset_check_rc"] = check.poll()
    records.driver["determinism_rc"] = check_determinism(args, records, meta, cards[0])
    records.driver["dataset_s"] = round(time.time() - t_start, 1)
    records.save()
    missed = check.poll() != 0 or records.driver["determinism_rc"] not in (0, None)
    if ok:
        ok = train_jobs(args, cards, records, t_start)
    else:
        print("a sweep process failed: no training", flush=True)
    records.driver["total_s"] = round(time.time() - t_start, 1)
    records.driver["ok"] = ok and not missed
    records.save()
    print(f"pipeline_cards: {'ok' if ok else 'a process failed or a bound missed'}; dataset check "
          f"rc {check.poll()}, determinism rc {records.driver['determinism_rc']}; "
          f"{records.driver['total_s']} s", flush=True)
    return 0 if ok and not missed else 1


if __name__ == "__main__":
    sys.exit(main())
