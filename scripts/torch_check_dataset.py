#!/usr/bin/env python
"""Hold a dataset that the port built on the card (``scripts/torch_datagen_full.py``
and ``scripts/torch_datagen_topup.py``) to the JAX package's record of the
same sweep, chunk by chunk: the port's counterpart of
``scripts/check_dataset_determinism.py``.

The JAX script demands equality, because it compares XLA on one chip with
itself.  The port does other float32 arithmetic on other hardware, and a
cavity whose |d mean(u)| sits near the convergence tolerance can cross it
an interval sooner or later, so the comparison takes bounds:

* a chunk that JAX converged everywhere must converge everywhere, its
  cumulative ``steps`` within max(``STEPS_INTERVALS`` report intervals,
  ``STEPS_FRAC`` of JAX's) of JAX's;
* a chunk that JAX left with a cavity unconverged must run to JAX's steps
  (the cap), its ``converged`` count within ``CONVERGED_SLACK`` of JAX's.

The fixed fields (``grid, n, re, collision, turbulence, u_lid,
sweep_max_steps``) must be equal, ``n`` and ``re`` and ``max_steps``
against JAX's chunks that the dataset holds: a partial dataset is compared
on its own chunks.  A chunk JAX's record does not have is a breach.

Beside the bounds, and bounding nothing, the check reads (``readings``):
the converged cavities of both; over the chunks that every cavity of
converged in both runs, how many stop earlier in the port, how many later
and how many at JAX's step, with the two-sided sign test's p-value of the
earlier against the later (``sign_test_p``); and the median ratio of the
port's steps to JAX's over those chunks and over every shared chunk.

Usage (from the repository root):

    python scripts/torch_check_dataset.py [data/ml_full/metadata.json | data/ml_full]
        [docs/artifacts/ml_full/dataset_metadata.json] [--out FILE]

The first argument is the port's ``metadata.json`` or its dataset
directory (with ``chunks/``: the chunks are then read, and the fields they
do not hold are not compared).  Every chunk is printed beside JAX's numbers
(with its wall times from ``progress.jsonl`` and ``topup.jsonl`` where they
are), the comparison is written to ``--out``
(``docs/artifacts/torch/ml_dataset.json``), and the exit code is 1 on a
breach.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECORD = os.path.join(ROOT, "docs", "artifacts", "ml_full", "dataset_metadata.json")
OUT = os.path.join(ROOT, "docs", "artifacts", "torch", "ml_dataset.json")
FIELDS = ("grid", "n", "re", "collision", "turbulence", "u_lid", "sweep_max_steps")

REPORT_INTERVAL = 5_000                   # the sweep's (scripts/torch_datagen_full.py)
STEPS_INTERVALS = 2
STEPS_FRAC = 0.05
CONVERGED_SLACK = 1


def _from_chunks(data_dir: str) -> dict:
    """A record of the chunks in ``data_dir/chunks``: their stats, the grid,
    the Re values and the largest step count."""
    chunk_dir = os.path.join(data_dir, "chunks")
    stats, res, grid = [], [], None
    for fn in sorted(os.listdir(chunk_dir)):
        if not fn.endswith(".npz"):
            continue
        with np.load(os.path.join(chunk_dir, fn)) as z:
            b = len(z["re"])
            conv = z["converged"] if "converged" in z else np.zeros(b, dtype=bool)
            fail = z["failed"] if "failed" in z else np.zeros(b, dtype=bool)
            grid = int(z["f_final"].shape[-1])
            res.extend(float(r) for r in z["re"])
            stats.append({"re_lo": float(z["re"][0]), "re_hi": float(z["re"][-1]),
                          "steps": int(z["steps"]), "converged": int(np.sum(conv)),
                          "failed": int(np.sum(fail)), "of": b})
    return {"grid": grid, "n": len(res), "re": [min(res), max(res)] if res else None,
            "max_steps": max((c["steps"] for c in stats), default=0), "chunks": stats}


def load(path: str) -> dict:
    """The port's record: ``metadata.json``, or one made from a dataset
    directory's chunks."""
    if os.path.isdir(path):
        return _from_chunks(path)
    with open(path) as fh:
        return json.load(fh)


def _wall_times(data_dir: str) -> dict:
    """``re_lo -> {"sweep_s", "sweep_write_s", "topup_s", "topup_write_s"}``
    from the logs the port's scripts keep beside the dataset."""
    out = {}
    for log, run, write in (("progress.jsonl", "batch_s", "sweep"),
                            ("topup.jsonl", "run_s", "topup")):
        path = os.path.join(data_dir, log)
        if os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    r = json.loads(line)
                    out.setdefault(r["re_lo"], {}).update(
                        {f"{write}_s": r.get(run), f"{write}_write_s": r.get("write_s")})
    return out


def steps_bound(jax_steps: int) -> int:
    """How far a converged chunk's steps may lie from JAX's."""
    return max(STEPS_INTERVALS * REPORT_INTERVAL, int(STEPS_FRAC * jax_steps))


def sign_test_p(earlier: int, later: int) -> float:
    """The exact two-sided sign test of ``earlier`` against ``later`` (ties
    left out): twice the binomial tail at one half, at most 1."""
    n, k = earlier + later, min(earlier, later)
    return min(1.0, 2.0 * sum(math.comb(n, i) for i in range(k + 1)) / 2.0 ** n)


def readings(rows: list) -> dict:
    """How the port's stops lie against JAX's over the shared chunks that
    converged everywhere in both, and the steps' median ratio."""
    both = [r for r in rows if "jax_steps" in r and r["converged"] == r["of"]
            and r["jax_converged"] == r["of"]]
    earlier = sum(r["steps"] < r["jax_steps"] for r in both)
    later = sum(r["steps"] > r["jax_steps"] for r in both)
    shared = [r for r in rows if "jax_steps" in r]
    return {"converged_in_both": len(both), "earlier": earlier, "later": later,
            "same": len(both) - earlier - later, "sign_test_p": sign_test_p(earlier, later),
            "median_steps_ratio": float(np.median([r["steps"] / r["jax_steps"] for r in both]))
            if both else None,
            "median_steps_ratio_all": float(np.median([r["steps"] / r["jax_steps"]
                                                       for r in shared])) if shared else None}


def compare(new: dict, old: dict) -> dict:
    """The comparison: per chunk the port's numbers beside JAX's with the
    bound that applies and ``ok``, the fixed fields, and the breaches."""
    breaches = []
    old_chunks = {(c["re_lo"], c["re_hi"]): c for c in old["chunks"]}
    new_chunks = {(c["re_lo"], c["re_hi"]): c for c in new["chunks"]}
    shared = [old_chunks[k] for k in sorted(old_chunks) if k in new_chunks]
    want = {k: old.get(k) for k in FIELDS}
    want["n"] = sum(c["of"] for c in shared)
    want["re"] = [min(c["re_lo"] for c in shared), max(c["re_hi"] for c in shared)] \
        if shared else None
    want["max_steps"] = max((c["steps"] for c in shared), default=0)
    fields = {}
    for key in (*FIELDS, "max_steps"):
        if key not in new:
            continue
        fields[key] = {"port": new[key], "jax": want[key], "ok": new[key] == want[key]}
        if new[key] != want[key]:
            breaches.append(f"{key}: port={new[key]} jax={want[key]}")
    rows = []
    for key in sorted(new_chunks):
        n = new_chunks[key]
        row = {"re_lo": n["re_lo"], "re_hi": n["re_hi"], "of": n["of"],
               "steps": n["steps"], "converged": n["converged"]}
        o = old_chunks.get(key)
        if o is None:
            row.update(ok=False, rule="not in the JAX record")
            breaches.append(f"chunk Re[{key[0]:g}..{key[1]:g}]: not in the JAX record")
            rows.append(row)
            continue
        row.update(jax_steps=o["steps"], jax_converged=o["converged"])
        if o["converged"] == o["of"]:
            slack = steps_bound(o["steps"])
            row["rule"] = f"converged {o['of']}/{o['of']}, |d steps| <= {slack}"
            row["ok"] = n["converged"] == n["of"] == o["of"] and abs(
                n["steps"] - o["steps"]) <= slack
        else:
            row["rule"] = f"steps == {o['steps']}, |d converged| <= {CONVERGED_SLACK}"
            row["ok"] = n["steps"] == o["steps"] and n["of"] == o["of"] and abs(
                n["converged"] - o["converged"]) <= CONVERGED_SLACK
        if not row["ok"]:
            breaches.append(
                f"chunk Re[{key[0]:g}..{key[1]:g}]: port steps={n['steps']} "
                f"conv={n['converged']}/{n['of']} | jax steps={o['steps']} "
                f"conv={o['converged']}/{o['of']} ({row['rule']})")
        rows.append(row)
    return {"fields": fields, "chunks": rows, "breaches": breaches,
            "agree": sum(r["ok"] for r in rows), "of": len(rows),
            "converged_cavities": {"port": sum(c["converged"] for c in new["chunks"]),
                                   "jax": sum(c["converged"] for c in shared)},
            "readings": readings(rows), "ok": not breaches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("new", nargs="?", default=os.path.join(ROOT, "data", "ml_full",
                                                             "metadata.json"))
    ap.add_argument("old", nargs="?", default=JAX_RECORD)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    new, old = load(args.new), load(args.old)
    result = compare(new, old)
    data_dir = args.new if os.path.isdir(args.new) else os.path.dirname(args.new)
    walls = _wall_times(data_dir)
    for row in result["chunks"]:
        row.update(walls.get(row["re_lo"], {}))
        print(f"chunk Re[{row['re_lo']:g}..{row['re_hi']:g}]: port steps {row['steps']} "
              f"converged {row['converged']}/{row['of']} | JAX steps "
              f"{row.get('jax_steps')} converged {row.get('jax_converged')} | "
              f"{row['rule']}: {'ok' if row['ok'] else 'BREACH'}"
              + "".join(f", {k} {row[k]}" for k in ("sweep_s", "sweep_write_s", "topup_s",
                                                    "topup_write_s") if row.get(k) is not None),
              flush=True)
    for key, f in result["fields"].items():
        print(f"{key}: port {f['port']} | JAX {f['jax']}: {'ok' if f['ok'] else 'BREACH'}")
    cc = result["converged_cavities"]
    print(f"chunks within bounds: {result['agree']}/{result['of']}; converged cavities: "
          f"port {cc['port']}, JAX {cc['jax']}")
    rd = result["readings"]
    print(f"readings: of {rd['converged_in_both']} chunks converged everywhere in both, "
          f"{rd['earlier']} stop earlier in the port, {rd['later']} later, {rd['same']} at "
          f"JAX's step (sign test p = {rd['sign_test_p']:.4g}); median port/JAX steps "
          f"{rd['median_steps_ratio']} there, {rd['median_steps_ratio_all']} over every chunk")
    for b in result["breaches"]:
        print("BREACH:", b)
    print("WITHIN BOUNDS" if result["ok"] else f"{len(result['breaches'])} breaches")
    result["port_record"], result["jax_record"] = (os.path.relpath(p, ROOT)
                                                   for p in (args.new, args.old))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
