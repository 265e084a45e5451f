"""ML surrogate pipeline (layer L6): Reynolds-sweep dataset generation and
the encoder-decoder CNN family that predicts steady-state cavity velocity
fields from (feq, Re, BC) inputs (reference: ``MRT_GPU_datagen.py`` +
``CNN_One`` ... ``CNN_Ten``), as the JAX package's ``ml/`` has them.

``generate_dataset`` runs the sweep on the card through the sweep form of
the CUDA pull kernel (over the cards of a mesh, one stack each);
``train`` trains the CNN with optax's update rules (data-parallel over a
mesh, resumable from its checkpoints); ``predict`` serves it."""

from .datagen import (
    generate_dataset, save_dataset, load_dataset, drop_failed, DatasetArrays,
)
from .models import CavityCNN, PRESETS, make_model
from .scaling import MinMaxScaler

__all__ = [
    "generate_dataset",
    "save_dataset",
    "load_dataset",
    "drop_failed",
    "DatasetArrays",
    "CavityCNN",
    "PRESETS",
    "make_model",
    "MinMaxScaler",
]
