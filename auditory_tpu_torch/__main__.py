"""``python -m auditory_tpu_torch``: the command-line interface."""

from .cli import entry

entry()
