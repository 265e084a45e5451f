#!/usr/bin/env python
"""Compare a rebuilt sweep dataset with an earlier run's record: the port's
counterpart of ``scripts/check_dataset_determinism.py``.

The sweep is deterministic by construction: the same ``SimConfig``, the
same partition of the Re values into chunks, the same convergence gate,
and on the card a kernel without atomics whose ``mean u`` is reduced in
float64 on the host.  So a rebuild should reproduce the earlier record
chunk for chunk: the same cumulative ``steps``, ``converged`` and
``failed`` counts.  This script checks that claim field by field and chunk
by chunk and prints every mismatch.  The default record is the port's own
whole-sweep run, ``docs/artifacts/torch/ml_full/metadata.json``, as the
JAX script checks against its own earlier run.

``--assemble-partial`` compares a rebuild of some chunks only (a dataset
assembled with ``torch_datagen_full.py --assemble-partial``) on the chunks
it holds, and says how many those are; the fields that follow from the
chunks present (``n``, ``re``, ``max_steps``) are then not compared.
Without it a chunk on one side only is a mismatch.  Nothing runs on a device: the script reads two JSON
files.  ``--out`` writes the result as JSON.

Usage:

    python scripts/torch_check_dataset_determinism.py [new_metadata] [old_record]
        [--assemble-partial] [--out result.json]

Exit code 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "docs", "artifacts", "torch", "ml_full", "metadata.json")
# the configuration's fields, and those that follow from the chunks present
FIELDS = ("grid", "n", "re", "collision", "turbulence", "u_lid", "max_steps",
          "sweep_max_steps")
PARTIAL_FIELDS = ("n", "re", "max_steps")
CHUNK_KEYS = ("steps", "converged", "failed")


def compare(new: dict, old: dict, partial: bool = False) -> dict:
    """The rebuild ``new`` against the record ``old``: the chunks compared,
    those that agree in ``CHUNK_KEYS``, and every mismatch as a line."""
    mismatches = []
    for field in FIELDS:
        if partial and field in PARTIAL_FIELDS:
            continue
        if new.get(field) != old.get(field):
            mismatches.append(f"{field}: old={old.get(field)} new={new.get(field)}")

    old_chunks = {(c["re_lo"], c["re_hi"]): c for c in old["chunks"]}
    new_chunks = {(c["re_lo"], c["re_hi"]): c for c in new["chunks"]}
    only_old = sorted(set(old_chunks) - set(new_chunks))
    only_new = sorted(set(new_chunks) - set(old_chunks))
    if only_new or (only_old and not partial):
        mismatches.append(
            f"chunk partition differs: {len(old_chunks)} vs {len(new_chunks)} chunks; "
            f"only-old={only_old[:3]} only-new={only_new[:3]}")
    both = sorted(set(old_chunks) & set(new_chunks))
    agree = 0
    for key in both:
        o, n = old_chunks[key], new_chunks[key]
        if all(o.get(k, 0) == n.get(k, 0) for k in CHUNK_KEYS):
            agree += 1
        else:
            mismatches.append(
                f"chunk Re[{key[0]:.0f}..{key[1]:.0f}]: "
                + " ".join(f"old {k}={o.get(k, 0)}" for k in CHUNK_KEYS) + " | "
                + " ".join(f"new {k}={n.get(k, 0)}" for k in CHUNK_KEYS))
    converged = {"old": sum(old_chunks[k]["converged"] for k in both),
                 "new": sum(new_chunks[k]["converged"] for k in both)}
    return {"compared": len(both), "of": len(old_chunks), "agree": agree,
            "converged_in_compared": converged, "partial": partial,
            "mismatches": mismatches, "deterministic": not mismatches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("new", nargs="?", default=os.path.join(ROOT, "data", "ml_full",
                                                         "metadata.json"))
    ap.add_argument("old", nargs="?", default=RECORD)
    ap.add_argument("--assemble-partial", action="store_true",
                    help="compare only the chunks the rebuild holds")
    ap.add_argument("--out", default=None, help="write the result here as JSON")
    args = ap.parse_args(argv)
    with open(args.new) as fh:
        new = json.load(fh)
    with open(args.old) as fh:
        old = json.load(fh)
    out = compare(new, old, args.assemble_partial)
    out.update(new_path=args.new, old_path=args.old)
    print(f"chunks agreeing ({', '.join(CHUNK_KEYS)}): {out['agree']}/{out['compared']} "
          f"compared of the record's {out['of']}")
    print(f"converged_cavities: old={old.get('converged_cavities')} "
          f"new={new.get('converged_cavities')}; in the chunks compared "
          f"old={out['converged_in_compared']['old']} new={out['converged_in_compared']['new']}")
    for m in out["mismatches"]:
        print("MISMATCH:", m)
    print("DETERMINISTIC" if out["deterministic"] else f"{len(out['mismatches'])} mismatches")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0 if out["deterministic"] else 1


if __name__ == "__main__":
    sys.exit(main())
