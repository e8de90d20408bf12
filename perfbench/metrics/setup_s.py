"""Process start to the first timed step, in seconds."""


def read(rec):
    return rec["setup_s"]
