"""Device ms a BERT step of the amp.step span: unscale, flatten, the
optimizer, the overflow select and the model copy."""
from perfbench.lib import spans


def read(rec):
    return spans.ms_per_step(rec, "amp_update")
