"""Device ms a BERT step of the model.embed span: token and position
rows, the embedding layer norm and the stacked leaves' unbind, forward
and backward."""
from perfbench.lib import spans


def read(rec):
    return spans.ms_per_step(rec, "embed")
