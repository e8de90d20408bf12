"""Device ms a BERT step of the model.mlp span: ln2, w1, GELU, w2 and
the residual add, forward and backward."""
from perfbench.lib import spans


def read(rec):
    return spans.ms_per_step(rec, "mlp")
