"""Device ms a BERT step of the model.head and model.loss spans: the
head layer norm, the tied GEMM and the cross-entropy, forward and
backward."""
from perfbench.lib import spans


def read(rec):
    return spans.ms_per_step(rec, "head_loss")
