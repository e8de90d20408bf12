"""Device ms a BERT step of the model.attention span: ln1, the QKV
projection, the attention core and the out projection, forward and
backward."""
from perfbench.lib import spans


def read(rec):
    return spans.ms_per_step(rec, "attention")
