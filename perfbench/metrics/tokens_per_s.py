"""Tokens of every step completed in the window over its wall time."""
from perfbench.lib import readers


def read(rec):
    return readers.rate(rec, "tokens")
