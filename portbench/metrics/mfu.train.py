"""``mfu.train``: ``readings.mfu`` of a train cell's traced run."""

from portbench import readings


def read(record):
    return readings.mfu(record, "train")
