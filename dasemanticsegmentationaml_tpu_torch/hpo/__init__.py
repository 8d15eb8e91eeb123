"""Hyperparameter optimization harness (reference experiment_nni.py +
train_nni.py equivalents; the port of ``dasemanticsegmentationaml_tpu/
hpo/``): trials are DA runs of the port's CLI on the card."""

from .search import SEARCH_SPACE, AnnealTuner, sample_space
from .experiment import run_experiment

__all__ = ["SEARCH_SPACE", "AnnealTuner", "sample_space", "run_experiment"]
