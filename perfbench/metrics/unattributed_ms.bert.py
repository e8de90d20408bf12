"""Device ms a BERT step that no model or amp span owns, the train.*
glue included."""
from perfbench.lib import spans


def read(rec):
    return spans.ms_per_step(rec, "unattributed")
