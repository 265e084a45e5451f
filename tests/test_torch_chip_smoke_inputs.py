"""``.chiprunignore`` leaves ``docs/artifacts`` out of the copy of the repo
that a run on the card gets, entry by entry, all but the files
``chip_smoke.py``, the port's slow gates and validation runs
(``scripts/torch_slow_gates.py``, ``scripts/torch_validate.py``) and the
surrogate pipeline's scripts (``scripts/torch_check_dataset.py``,
``torch_predict_extrapolate.py``, ``torch_ml_demo.py``,
``torch_demo_plateau.py``, ``torch_datagen_precision.py``,
``torch_train_full.py``, and since the scripts of the other training runs,
``torch_train_eight_faithful.py``, ``torch_train_early_presets.py``,
``torch_diagnose_cnn_eight.py``, and the determinism check's record of the
port's own sweep, and since the last three scripts, ``torch_probe_fidelity.py``,
``torch_rollup_validation.py`` and ``torch_weak_scaling_cpu.py``, JAX's
``probes.json``, ``validation_rollup.json`` and ``weak_scaling_cpu.json``,
and the JAX package's own initial weights of ``cnn_nine`` that the
pipeline runner's jobs ``cnn_nine_jax0`` and ``cnn_nine_jax0_tpu`` start
from) read there:
a file added to ``docs/artifacts`` that the list does not name would reach
that copy unseen."""

import importlib.util
import os
from pathlib import Path

import chip_smoke

REPO = Path(__file__).resolve().parent.parent
ARTIFACTS = REPO / "docs" / "artifacts"


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listed() -> set[str]:
    lines = (REPO / ".chiprunignore").read_text().splitlines()
    return {line.strip().rstrip("/") for line in lines
            if line.strip() and not line.lstrip().startswith("#")}


def _needed() -> set[str]:
    stems = [os.path.join(chip_smoke.ARTIFACT_WEIGHTS, f"{chip_smoke.ARTIFACT_PRESET}_{c}")
             for c in "xy"]
    paths = [s + ext for s in stems for ext in (".msgpack", ".json")]
    paths.append(chip_smoke.ARTIFACT_CKPT)
    validate = _script("torch_validate")
    paths += [_script("torch_slow_gates").JAX_RECORD, *validate.JAX_RECORDS,
              *validate.JAX_HISTORY.values()]
    extrapolate = _script("torch_predict_extrapolate")
    paths += [os.path.join(REPO, d, f"{name}_{c}{ext}")
              for name, d in extrapolate.WEIGHT_DIRS.items() for c in "xy"
              for ext in (".msgpack", ".json")]
    paths += [os.path.join(REPO, extrapolate.JAX_DIR, "summary.json"),
              *(extrapolate.jax_truth_path(str(REPO), re) for re in (7500.0, 10000.0)),
              _script("torch_check_dataset").JAX_RECORD, _script("torch_ml_demo").JAX_METRICS,
              _script("torch_demo_plateau").JAX_HISTORY, _script("torch_datagen_precision").JAX_RECORD,
              *_script("torch_train_full").JAX_RECORDS,
              _script("torch_check_dataset_determinism").RECORD,
              _script("torch_diagnose_cnn_eight").JAX_RECORD]
    faithful = _script("torch_train_eight_faithful")
    paths += [os.path.join(faithful.JAX_DIR, d, "summary.json")
              for d in ("cnn_eight_faithful", "cnn_eight_glorot")]
    paths += [os.path.join(_script("torch_train_early_presets").JAX_ARTIFACTS, d, "summary.json")
              for d in ("ml_early", "ml_early_ref_budget", "ml_early_glorot")]
    probes = _script("torch_probe_fidelity")
    paths += [probes.JAX_PROBES, probes.JAX_RECORD, _script("torch_rollup_validation").JAX_ROLLUP,
              _script("torch_weak_scaling_cpu").JAX_RECORD]
    paths.append(_script("torch_pipeline_cards").JAX_INIT)
    return {Path(p).resolve().relative_to(REPO).as_posix() for p in paths}


def test_the_files_chip_smoke_reads_are_not_listed():
    listed, needed = _listed(), _needed()
    for rel in needed:
        assert (REPO / rel).is_file(), rel
        parts = rel.split("/")
        ancestors = {"/".join(parts[:i]) for i in range(1, len(parts) + 1)}
        assert not ancestors & listed, rel


def test_every_other_entry_of_docs_artifacts_is_listed():
    listed, needed = _listed(), _needed()
    keep = needed | {"/".join(p.split("/")[:i]) for p in needed
                     for i in range(1, p.count("/") + 1)}
    unlisted = []
    for root, dirs, files in os.walk(ARTIFACTS):
        base = Path(root).relative_to(REPO).as_posix()
        for name in sorted(files):
            rel = f"{base}/{name}"
            if rel not in listed and rel not in needed:
                unlisted.append(rel)
        for name in list(dirs):
            rel = f"{base}/{name}"
            if rel in listed:
                dirs.remove(name)
            elif rel not in keep:
                unlisted.append(rel)
                dirs.remove(name)
    assert not unlisted, unlisted
