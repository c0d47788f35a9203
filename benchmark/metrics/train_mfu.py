"""train_mfu (%): a training step's model operations (``costs/llama.py``)
over its time in the traced stretch, of the card's bf16 peak."""

from benchmark import rooflines


def read(reading):
    return rooflines.mfu(reading)
